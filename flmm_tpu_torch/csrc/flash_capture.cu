// Causal flash attention with key-validity holes that also emits the
// mean-merged text->image attention per mask, without an S x S matrix.
//
// Replaces flmm_tpu/ops/flash_attention.py::flash_attention_with_merged_capture
// (K5, the pallas_call at :246):
//
//   out[b, h, i]        = sum_j p(i, j) v[b, h, j]
//   merged[b, h, m, n]  = sum_i mm[b, i, m] p(i, img_start + n),  n < n_img
//
// with p the softmax over keys j <= i with key_valid[b, j] (a row with no
// such key gives p = 0 and out = 0, the TPU kernel's guard).
//
// What bounds it on an H100: at the LLaVA-NeXT shape (B = 2, H = 32,
// S = 3200, hd = 128) the two causal products are ~170 GFLOP per layer, so
// the work is tensor-core and exp time; the (B, H, S, S) scores must not
// reach device memory.  The TPU kernel keeps a (128, n_img_pad) f32 row
// accumulator per query block in VMEM (1.5 MB at n_img = 2928) and adds its
// merged product into one output across a sequential grid; an SM has
// 228 KB, and blocks run in no order.  So the work is two kernels:
//
// 1. flash_fwd: FlashAttention-2 style, one block per 64 query rows of one
//    (b, h), 4 warps of 16 rows.  Each warp keeps its Q fragments, scores,
//    probabilities and f32 output accumulator in registers (raw
//    mma.sync.m16n8k16) while 64-key tiles of K and V^T stream through
//    shared memory; only the key tiles at or below the diagonal are
//    visited.  It writes out and the row log-sum-exp (base 2).
// 2. capture: one block per (b, h) and 128 image keys, 32 per warp, whose
//    K rows stay in registers as the A operand.  It walks the query blocks
//    that can see those keys in a fixed order, skips those whose merge rows
//    are all zero (they add exactly 0; for F-LMM only the caption rows are
//    not), recomputes the scores transposed (keys x queries) from a shared
//    Q tile, turns them into probabilities with the saved log-sum-exp, and
//    accumulates mm^T p in registers.  Each output element has one owner
//    and one summation order: no atomics, no partial buffer, and the same
//    bits on every run.  p and mm enter the tensor cores as bf16 hi + lo
//    pairs (three products), so the merge keeps ~f32 accuracy where the TPU
//    kernel rounded both to bf16.
//
// Not yet: load/compute overlap (cp.async or TMA), wgmma, ldmatrix.
//
// Layout: element (b, h, t, d) of q is at b * q_b + h * q_h + t * q_t + d
// (likewise k, v with their own strides and head h / (H / KV), so GQA needs
// no repeated copies, and out with its strides); key_valid is (B, S)
// bytes, mm is (B, S, M) f32, lse is (B * H, S) f32 scratch and merged is
// (B, H, M, n_img) f32.  Strides are multiples of 8 elements.
#include "common.cuh"

namespace {

constexpr int HD = 128, BQ = 64, BKV = 64, WARPS = 4, THREADS = WARPS * 32;
constexpr int LD = HD + 8;      // Q / K rows in shared memory
constexpr int VT_LD = BKV + 8;  // V^T rows
constexpr int BN = 128;         // image keys per capture block, 32 per warp
constexpr int MAX_M = 32;

struct Strides {
  long long b, h, t;
};

// (x, y) -> bf16x2 hi and the bf16x2 of what hi leaves out.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, Strides qs,
                 const bf16* __restrict__ k, Strides ks,
                 const bf16* __restrict__ v, Strides vs, int H, int rep,
                 int S, const unsigned char* __restrict__ key_valid,
                 float scale_log2, bf16* __restrict__ out, Strides os,
                 float* __restrict__ lse) {
  __shared__ __align__(16) bf16 Ks[BKV * LD];
  __shared__ __align__(16) bf16 Vt[HD * VT_LD];
  __shared__ unsigned char kok[BKV];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / rep;
  const bf16* qp = q + b * qs.b + h * qs.h;
  const bf16* kp = k + b * ks.b + hk * ks.h;
  const bf16* vp = v + b * vs.b + hk * vs.h;
  const unsigned char* valid = key_valid + (long long)b * S;

  // this thread's two query rows (fragment rows lane/4 and lane/4 + 8) and
  // column pair (lane%4)*2; Q fragments straight from device memory
  const int qr = lane / 4, qc = (lane % 4) * 2;
  const int t0 = q0 + warp * 16 + qr, t1 = t0 + 8;
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const bf16* p0 = qp + t0 * qs.t + kk * 16 + qc;
    const bf16* p1 = qp + t1 * qs.t + kk * 16 + qc;
    qf[kk][0] = ld32(p0);
    qf[kk][1] = ld32(p1);
    qf[kk][2] = ld32(p0 + 8);
    qf[kk][3] = ld32(p1 + 8);
  }

  float o[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  for (int kv0 = 0; kv0 <= q0; kv0 += BKV) {
    // stage K row-major and V transposed (V^T rows are the B operand of P V)
    for (int idx = tid; idx < BKV * HD / 8; idx += THREADS) {
      const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
      const uint4 kv = *reinterpret_cast<const uint4*>(
          kp + (long long)(kv0 + r) * ks.t + c);
      const uint4 vv = *reinterpret_cast<const uint4*>(
          vp + (long long)(kv0 + r) * vs.t + c);
      *reinterpret_cast<uint4*>(Ks + r * LD + c) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c + j) * VT_LD + r] = ve[j];
    }
    if (tid < BKV) kok[tid] = valid[kv0 + tid];
    __syncthreads();

    // scores: Q (16 x HD) @ K^T (HD x 64), eight 16 x 8 tiles
    float s[BKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt)
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt) {
        const bf16* kb = Ks + (nt * 8 + qr) * LD + kk * 16 + qc;
        const uint32_t bfr[2] = {ld32(kb), ld32(kb + 8)};
        mma_16816(s[nt], qf[kk], bfr);
      }

    // causal & key_valid mask, online softmax in base 2
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kl = nt * 8 + qc + e, key = kv0 + kl;
        const bool ok = kok[kl] != 0;
        s[nt][e] = ok && key <= t0 ? s[nt][e] * scale_log2 : -CUDART_INF_F;
        s[nt][2 + e] =
            ok && key <= t1 ? s[nt][2 + e] * scale_log2 : -CUDART_INF_F;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    // a row with no visible key so far keeps p = 0 (exp2(-inf - 0)) and
    // alpha = 0, never exp2(-inf + inf)
    const float mb0 = mn0 == -CUDART_INF_F ? 0.f : mn0;
    const float mb1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
    const float alpha0 = exp2f(m0 - mb0), alpha1 = exp2f(m1 - mb1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = exp2f(s[nt][e] - mb0);
        s[nt][2 + e] = exp2f(s[nt][2 + e] - mb1);
        ps0 += s[nt][e];
        ps1 += s[nt][2 + e];
      }
    l0 = l0 * alpha0 + ps0;  // this thread's columns; summed over the quad
    l1 = l1 * alpha1 + ps1;  // at the end
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      o[dt][0] *= alpha0;
      o[dt][1] *= alpha0;
      o[dt][2] *= alpha1;
      o[dt][3] *= alpha1;
    }

    // O += P (16 x 64 keys) @ V (64 keys x HD); the score accumulators of
    // two adjacent 8-key tiles are exactly one A fragment
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) {
      const uint32_t a[4] = {
          pack2(s[2 * j][0], s[2 * j][1]), pack2(s[2 * j][2], s[2 * j][3]),
          pack2(s[2 * j + 1][0], s[2 * j + 1][1]),
          pack2(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        const bf16* vb = Vt + (dt * 8 + qr) * VT_LD + j * 16 + qc;
        const uint32_t bfr[2] = {ld32(vb), ld32(vb + 8)};
        mma_16816(o[dt], a, bfr);
      }
    }
    __syncthreads();  // K, V^T and the key flags are restaged next
  }

  const float L0 = quad_sum(l0), L1 = quad_sum(l1);
  const float inv0 = 1.f / fmaxf(L0, 1e-30f), inv1 = 1.f / fmaxf(L1, 1e-30f);
  bf16* op = out + b * os.b + h * os.h;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int d = dt * 8 + qc;
    *reinterpret_cast<uint32_t*>(op + t0 * os.t + d) =
        pack2(o[dt][0] * inv0, o[dt][1] * inv0);
    *reinterpret_cast<uint32_t*>(op + t1 * os.t + d) =
        pack2(o[dt][2] * inv1, o[dt][3] * inv1);
  }
  if (lane % 4 == 0) {  // -inf for a row that saw no key
    lse[(long long)bh * S + t0] = m0 + log2f(L0);
    lse[(long long)bh * S + t1] = m1 + log2f(L1);
  }
}

template <int NT>  // NT tiles of 8 masks
__global__ void __launch_bounds__(THREADS)
capture_kernel(const bf16* __restrict__ q, Strides qs,
               const bf16* __restrict__ k, Strides ks, int H, int rep, int S,
               const unsigned char* __restrict__ key_valid, float scale_log2,
               const float* __restrict__ lse, const float* __restrict__ mm,
               int M, int img_start, int n_img, float* __restrict__ merged) {
  constexpr int MP = NT * 8;
  __shared__ __align__(16) bf16 Qs[BQ * LD];
  __shared__ float Ms[BQ * MP];
  __shared__ float Ls[BQ];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, hk = h / rep;
  const int key0 = img_start + blockIdx.x * BN;  // the block's first key
  const int kw = key0 + warp * 32;               // this warp's first key
  const bf16* qp = q + b * qs.b + h * qs.h;
  const bf16* kp = k + b * ks.b + hk * ks.h;
  const unsigned char* valid = key_valid + (long long)b * S;
  const float* lse_bh = lse + (long long)bh * S;
  const float* mm_b = mm + (long long)b * S * M;
  const int qr = lane / 4, qc = (lane % 4) * 2;

  // the warp's 32 K rows as two 16-row A fragments, for the whole block
  uint32_t kf[2][HD / 16][4];
  bool kok[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r0 = kw + mt * 16 + qr, r1 = r0 + 8;
    kok[mt][0] = valid[r0] != 0;
    kok[mt][1] = valid[r1] != 0;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const bf16* p0 = kp + (long long)r0 * ks.t + kk * 16 + qc;
      const bf16* p1 = kp + (long long)r1 * ks.t + kk * 16 + qc;
      kf[mt][kk][0] = ld32(p0);
      kf[mt][kk][1] = ld32(p1);
      kf[mt][kk][2] = ld32(p0 + 8);
      kf[mt][kk][3] = ld32(p1 + 8);
    }
  }
  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;

  // query blocks from the first one that sees key0 (key0 % BQ == 0)
  for (int q0 = key0; q0 < S; q0 += BQ) {
    bool nz = false;
    for (int idx = tid; idx < BQ * MP; idx += THREADS) {
      const int r = idx / MP, c = idx % MP;
      const float x = c < M ? mm_b[(long long)(q0 + r) * M + c] : 0.f;
      Ms[idx] = x;
      nz |= x != 0.f;
    }
    if (!__syncthreads_or(nz)) continue;  // rows that merge into no mask
    for (int idx = tid; idx < BQ * HD / 8; idx += THREADS) {
      const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
      *reinterpret_cast<uint4*>(Qs + r * LD + c) =
          *reinterpret_cast<const uint4*>(qp + (long long)(q0 + r) * qs.t + c);
    }
    if (tid < BQ) Ls[tid] = lse_bh[q0 + tid];
    __syncthreads();

    // scores transposed: K (32 x HD) @ Q^T (HD x 64 queries)
    float st[2][BQ / 8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt)
        for (int e = 0; e < 4; ++e) st[mt][nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        const bf16* qb = Qs + (nt * 8 + qr) * LD + kk * 16 + qc;
        const uint32_t bfr[2] = {ld32(qb), ld32(qb + 8)};
        mma_16816(st[0][nt], kf[0][kk], bfr);
        mma_16816(st[1][nt], kf[1][kk], bfr);
      }

    // probabilities p(query, key) from the saved row log-sum-exp
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kw + mt * 16 + qr + (e >> 1) * 8;
          const int ql = nt * 8 + qc + (e & 1);
          st[mt][nt][e] = kok[mt][e >> 1] && key <= q0 + ql
              ? exp2f(st[mt][nt][e] * scale_log2 - Ls[ql]) : 0.f;
        }

    // acc^T (keys x masks) += P^T (keys x 16 queries) @ mm (16 queries x
    // masks); the accumulators of two adjacent 8-query tiles are one A
    // fragment, as in flash_fwd's P V
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j) {
        uint32_t ahi[4], alo[4];
        split2(st[mt][2 * j][0], st[mt][2 * j][1], ahi[0], alo[0]);
        split2(st[mt][2 * j][2], st[mt][2 * j][3], ahi[1], alo[1]);
        split2(st[mt][2 * j + 1][0], st[mt][2 * j + 1][1], ahi[2], alo[2]);
        split2(st[mt][2 * j + 1][2], st[mt][2 * j + 1][3], ahi[3], alo[3]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          // B[query][mask]: column n*8 + qr at query rows qc, qc+1, +8, +9
          const float* mb = Ms + (j * 16 + qc) * MP + n * 8 + qr;
          uint32_t bhi[2], blo[2];
          split2(mb[0], mb[MP], bhi[0], blo[0]);
          split2(mb[8 * MP], mb[9 * MP], bhi[1], blo[1]);
          mma_16816(acc[mt][n], ahi, bhi);
          mma_16816(acc[mt][n], alo, bhi);
          mma_16816(acc[mt][n], ahi, blo);
        }
      }
    __syncthreads();  // Qs, Ms and Ls are restaged next
  }

  // acc[mt][n] holds keys kw + mt*16 + qr (+8) x masks n*8 + qc (+1)
  float* out_bh = merged + (long long)bh * M * n_img;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kw + mt * 16 + qr + (e >> 1) * 8 - img_start;
        const int m = n * 8 + qc + (e & 1);
        if (m < M && col < n_img)
          out_bh[(long long)m * n_img + col] = acc[mt][n][e];
      }
}

template <int NT>
void launch_capture(dim3 grid, cudaStream_t st, const bf16* q, Strides qs,
                    const bf16* k, Strides ks, int H, int rep, int S,
                    const unsigned char* key_valid, float scale_log2,
                    const float* lse, const float* mm, int M, int img_start,
                    int n_img, float* merged) {
  capture_kernel<NT><<<grid, THREADS, 0, st>>>(q, qs, k, ks, H, rep, S,
                                               key_valid, scale_log2, lse, mm,
                                               M, img_start, n_img, merged);
}

}  // namespace

extern "C" int flmm_flash_capture(
    const void* q, long long q_b, long long q_h, long long q_t, const void* k,
    long long k_b, long long k_h, long long k_t, const void* v, long long v_b,
    long long v_h, long long v_t, int B, int H, int KV, int S, int head_dim,
    const void* key_valid, const void* mm, int M, int img_start, int n_img,
    void* out, long long o_b, long long o_h, long long o_t, void* lse,
    void* merged, void* stream) {
  const long long strides[] = {q_b, q_h, q_t, k_b, k_h, k_t,
                               v_b, v_h, v_t, o_b, o_h, o_t};
  for (long long s : strides)
    if (s % 8) return (int)cudaErrorInvalidValue;
  const int n_img_pad = (n_img + BN - 1) / BN * BN;
  if (head_dim != HD || B <= 0 || H <= 0 || KV <= 0 || H % KV || S <= 0 ||
      S % BN || img_start < 0 || img_start % BN || n_img <= 0 ||
      img_start + n_img_pad > S || M <= 0 || M > MAX_M || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)HD);
  const Strides qs{q_b, q_h, q_t}, ks{k_b, k_h, k_t}, vs{v_b, v_h, v_t},
      os{o_b, o_h, o_t};
  const int rep = H / KV;
  const unsigned char* valid = (const unsigned char*)key_valid;

  flash_fwd_kernel<<<dim3(S / BQ, B * H), THREADS, 0, st>>>(
      (const bf16*)q, qs, (const bf16*)k, ks, (const bf16*)v, vs, H, rep, S,
      valid, scale_log2, (bf16*)out, os, (float*)lse);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const dim3 grid(n_img_pad / BN, B * H);
  void (*launch)(dim3, cudaStream_t, const bf16*, Strides, const bf16*,
                 Strides, int, int, int, const unsigned char*, float,
                 const float*, const float*, int, int, int, float*) =
      M <= 8 ? launch_capture<1> : M <= 16 ? launch_capture<2>
      : M <= 24 ? launch_capture<3> : launch_capture<4>;
  launch(grid, st, (const bf16*)q, qs, (const bf16*)k, ks, H, rep, S, valid,
         scale_log2, (const float*)lse, (const float*)mm, M, img_start, n_img,
         (float*)merged);
  return (int)cudaGetLastError();
}
