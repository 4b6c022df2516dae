// Non-causal attention with the decomposed relative-position bias of SAM's
// ViTDet blocks, softmax in base 2.
//
// Replaces flmm_tpu/ops/sam_flash.py::sam_global_attention_v8 (K2, the
// pallas_call at :292) and serves the 16-head 14x14 window attention inside
// flmm_tpu/ops/window_block.py::window_block (K1).
//
//   score(i, j) = q_i . k_j + bias[i, j / side] + bias[i, side + j % side]
//
// with q pre-scaled by scale * log2(e) and the bias rows already in the
// log2 domain (both prepared outside, as the JAX package does), so
// p = exp2(score - max).  The TPU kernels fold the bias into one augmented-K
// product, [q | bias_h | bias_w] @ [k ; sel_h ; sel_w]^T, to keep the MXU
// busy; here the two bias terms come from a shared-memory copy of the
// block's bias rows and are added to the f32 scores in registers, which
// costs no tensor-core work and no padded K lanes.  Keys at or beyond S are
// masked, so any grid side works; pad *tokens* inside S are not masked (K1
// gives them k = b_k, v = b_v, as the reference does).
//
// What bounds it on an H100: at the global-layer shape (G = 64 image-heads,
// S = 4096, hd = 64) the two products are 275 GFLOP per layer and every
// score needs one exp2, so the work is tensor-core and SFU time; the
// (G, S, S) scores must never reach device memory.  The design is
// FlashAttention-2 style: a block owns 64 query rows of one (image, head),
// 4 warps of 16 rows; each warp keeps its Q fragments, its 16 x 64 scores,
// its probabilities and its 16 x 64 f32 output accumulator in registers
// (raw mma.sync.m16n8k16 bf16, whose fragment layout is known, so the
// softmax runs on the accumulators directly) while 64-key tiles of K and
// V^T stream through shared memory.  Not yet: load/compute overlap across
// tiles, wgmma.
//
// It also serves the split window path's attention, K6
// (flmm_tpu/ops/sam_flash.py::sam_window_attention_v9, the pallas_call at
// :122): 16 heads of 14x14 windows, T = 196, over the windowised qkv of a
// SAM-448 window layer (G = 512 window-heads at bs 8).  64-row query blocks
// cover T in 4 blocks, the last one 4 rows deep; keys past T are masked.
// A layer is only 5 GFLOP there, and padding T to 256 in the query blocks
// and key tiles wastes 41% of the products, so per-block staging and the
// idle tail bound it rather than the tensor cores.
//
// Layout: element (g, t, d) of k and v is at
//   (g / nh) * s_b + (g % nh) * s_h + t * s_t + d,
// and of q at the same with its own strides (q_b, q_h, q_t), so K2 passes
// contiguous (G, S, 64) tensors (nh = 1), K1 reads q, k, v straight out of
// its (NW, T, 3C) qkv tensor with heads at column offsets, and K6 reads k
// and v out of the windowised qkv beside a separately scaled q.  The output
// uses the same addressing with its own strides.  All strides and base
// offsets are multiples of 8 elements (16-byte loads).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int HD = 64, BQ = 64, BKV = 64, WARPS = 4, THREADS = WARPS * 32;
constexpr int K_LD = HD + 8;    // Ks[key][d]
constexpr int VT_LD = BKV + 8;  // Vt[d][key]

size_t smem_bytes(int side) {
  return (size_t)BKV * K_LD * 2 + (size_t)HD * VT_LD * 2 +
         (size_t)BQ * 2 * side * 4;
}

__global__ void __launch_bounds__(THREADS)
relpos_attention_kernel(const bf16* __restrict__ q, long long q_b,
                        long long q_h, long long q_t,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v, long long s_b,
                        long long s_h, long long s_t, int nh,
                        const bf16* __restrict__ bias, int side, int S,
                        bf16* __restrict__ out, long long o_b, long long o_h,
                        long long o_t) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vt = Ks + BKV * K_LD;
  float* Bsm = reinterpret_cast<float*>(Vt + HD * VT_LD);
  const int two_side = 2 * side;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = blockIdx.y, q0 = blockIdx.x * BQ;
  const long long q_off = (long long)(g / nh) * q_b + (long long)(g % nh) * q_h;
  const long long in_off = (long long)(g / nh) * s_b + (long long)(g % nh) * s_h;
  const long long out_off = (long long)(g / nh) * o_b + (long long)(g % nh) * o_h;

  for (int idx = tid; idx < BQ * two_side; idx += THREADS) {
    const int r = idx / two_side, j = idx % two_side, t = q0 + r;
    Bsm[idx] = t < S
        ? __bfloat162float(bias[((long long)g * S + t) * two_side + j]) : 0.f;
  }

  // This thread's two query rows (fragment rows lane/4 and lane/4 + 8) and
  // column pair (lane%4)*2; Q fragments straight from device memory.
  const int qr = lane / 4, qc = (lane % 4) * 2;
  const int t0 = q0 + warp * 16 + qr, t1 = t0 + 8;
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int d = kk * 16 + qc;
    const bf16* p0 = q + q_off + t0 * q_t + d;
    const bf16* p1 = q + q_off + t1 * q_t + d;
    qf[kk][0] = t0 < S ? ld32(p0) : 0u;
    qf[kk][1] = t1 < S ? ld32(p1) : 0u;
    qf[kk][2] = t0 < S ? ld32(p0 + 8) : 0u;
    qf[kk][3] = t1 < S ? ld32(p1 + 8) : 0u;
  }

  float o[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  const float* brow0 = Bsm + (warp * 16 + qr) * two_side;
  const float* brow1 = brow0 + 8 * two_side;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int kv0 = 0; kv0 < S; kv0 += BKV) {
    // stage K row-major and V transposed (V^T rows are the B operand of P V)
    for (int idx = tid; idx < BKV * HD / 8; idx += THREADS) {
      const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8, t = kv0 + r;
      uint4 kv = zero, vv = zero;
      if (t < S) {
        kv = *reinterpret_cast<const uint4*>(k + in_off + t * s_t + c);
        vv = *reinterpret_cast<const uint4*>(v + in_off + t * s_t + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * K_LD + c) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c + j) * VT_LD + r] = ve[j];
    }
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
        const bf16* kp = Ks + (nt * 8 + qr) * K_LD + kk * 16 + qc;
        const uint32_t b[2] = {ld32(kp), ld32(kp + 8)};
        mma_16816(s[nt], qf[kk], b);
      }

    // bias, key mask, online softmax in base 2
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kv0 + nt * 8 + qc + e;
        if (key < S) {
          const int bh = key / side, bw = side + key % side;
          s[nt][e] += brow0[bh] + brow0[bw];
          s[nt][2 + e] += brow1[bh] + brow1[bw];
        } else {
          s[nt][e] = -CUDART_INF_F;
          s[nt][2 + e] = -CUDART_INF_F;
        }
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = exp2f(s[nt][e] - mn0);
        s[nt][2 + e] = exp2f(s[nt][2 + e] - mn1);
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
        const bf16* vp = Vt + (dt * 8 + qr) * VT_LD + j * 16 + qc;
        const uint32_t b[2] = {ld32(vp), ld32(vp + 8)};
        mma_16816(o[dt], a, b);
      }
    }
    __syncthreads();  // K and V^T are restaged next
  }

  const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int d = dt * 8 + qc;
    if (t0 < S)
      *reinterpret_cast<uint32_t*>(out + out_off + t0 * o_t + d) =
          pack2(o[dt][0] * inv0, o[dt][1] * inv0);
    if (t1 < S)
      *reinterpret_cast<uint32_t*>(out + out_off + t1 * o_t + d) =
          pack2(o[dt][2] * inv1, o[dt][3] * inv1);
  }
}

}  // namespace

extern "C" int flmm_relpos_attention(const void* q, long long q_b,
                                     long long q_h, long long q_t,
                                     const void* k, const void* v,
                                     long long s_b,
                                     long long s_h, long long s_t, int nh,
                                     const void* bias, int side, int G, int S,
                                     int head_dim, void* out, long long o_b,
                                     long long o_h, long long o_t,
                                     void* stream) {
  if (head_dim != HD || G <= 0 || S <= 0 || nh <= 0 || side <= 0 ||
      side * side != S || G > 65535 || q_b % 8 || q_h % 8 || q_t % 8 ||
      s_b % 8 || s_h % 8 || s_t % 8 ||
      o_b % 2 || o_h % 2 || o_t % 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(side);
  const cudaError_t e = cudaFuncSetAttribute(
      relpos_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, G);
  relpos_attention_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, q_b, q_h, q_t, (const bf16*)k, (const bf16*)v, s_b,
      s_h, s_t, nh,
      (const bf16*)bias, side, S, (bf16*)out, o_b, o_h, o_t);
  return (int)cudaGetLastError();
}
