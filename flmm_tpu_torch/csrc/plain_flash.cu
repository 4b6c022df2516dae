// Bias-free, non-causal attention for ViT towers: softmax(q k^T / sqrt(hd)) v
// over (G, S, hd) heads with any S and hd in {64, 72}.
//
// Replaces flmm_tpu/ops/sam_flash.py::plain_flash_attention (K7, the
// pallas_call at :185).  The TPU kernel pads hd + 1 to 128 lanes, masks the
// padded keys through a -1e30 row of an augmented operand and reads the
// softmax denominator off a ones-column of v, all to feed whole MXU tiles
// from a one-shot softmax over the full key row.  None of that belongs on
// Hopper: this is a FlashAttention-2 style kernel with the running max and
// sum in registers.  A block owns 64 query rows of one (image, head), 4
// warps of 16 rows; each warp keeps its Q fragments, its 16 x 64 scores and
// its 16 x hd f32 output in registers (raw mma.sync.m16n8k16) while 64-key
// tiles of K and V^T pass through shared memory.  Keys at or beyond S are
// masked and query rows at or beyond S are never written, so S needs no
// padding (CLIP towers have S = 577).
//
// hd = 72 (SigLIP-SO400M: 1152 / 16 heads) is no multiple of the 16-deep
// k-step of the tensor cores: the score product runs over 80 columns whose
// last 8 are zero in both the Q fragments and the shared K tile; the P V
// product needs hd only as a multiple of 8, which 72 is.
//
// Numerics follow the TPU wrapper (:163): q * scale is computed in f32 and
// rounded to bf16 before the product (here on the way into the Q
// fragments); scores, softmax and accumulation are f32; the probabilities
// are rounded to bf16 for P V and the row sum divides at the end.
//
// What bounds it on an H100: at the HPT tower shape (G = 64, S = 1024,
// hd = 72) a layer is 19.3 GFLOP over 38 MB of operands, ~65x more tensor
// core time than memory time, so operations bound it; the (G, S, S) scores
// of the eager path (268 MB in f32 per layer) never exist.
//
// Layout: element (g, t, d) of q is at
//   (g / nh) * q_b + (g % nh) * q_h + t * q_t + d,
// k, v and the output likewise with their own strides, so the tower passes
// (B, H, S, hd) views of its (B, S, 3 * H * hd) qkv rows and gets
// (B, S, H, hd) memory back, with no transposed copies.  Input strides and
// base offsets are multiples of 8 elements (16-byte loads); 72 * 2 B = 144 B
// head offsets keep that.
#include "common.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, WARPS = 4, THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
__global__ void __launch_bounds__(THREADS)
plain_flash_kernel(const bf16* __restrict__ q, long long q_b, long long q_h,
                   long long q_t, const bf16* __restrict__ k, long long k_b,
                   long long k_h, long long k_t, const bf16* __restrict__ v,
                   long long v_b, long long v_h, long long v_t, int nh, int S,
                   float scale, bf16* __restrict__ out, long long o_b,
                   long long o_h, long long o_t) {
  constexpr int HDP = (HD + 15) / 16 * 16;  // depth of the score product
  constexpr int K_LD = HDP + 8;             // Ks[key][d]
  constexpr int VT_LD = BKV + 8;            // Vt[d][key]
  __shared__ __align__(16) bf16 Ks[BKV * K_LD];
  __shared__ __align__(16) bf16 Vt[HD * VT_LD];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = blockIdx.y, q0 = blockIdx.x * BQ;
  const long long gb = g / nh, gh = g % nh;
  q += gb * q_b + gh * q_h;
  k += gb * k_b + gh * k_h;
  v += gb * v_b + gh * v_h;
  out += gb * o_b + gh * o_h;

  // the zero columns [HD, HDP) of the K tile, written once
  if constexpr (HDP > HD) {
    constexpr int PAD = HDP - HD;
    for (int idx = tid; idx < BKV * PAD; idx += THREADS)
      Ks[(idx / PAD) * K_LD + HD + idx % PAD] = __float2bfloat16(0.f);
  }

  // This thread's two query rows (fragment rows lane/4 and lane/4 + 8) and
  // column pair (lane%4)*2; Q fragments from device memory, scaled in f32
  // and rounded to bf16.
  const int qr = lane / 4, qc = (lane % 4) * 2;
  const int t0 = q0 + warp * 16 + qr, t1 = t0 + 8;
  auto load_q = [&](int t, int d) -> uint32_t {
    if (t >= S || d >= HD) return 0u;
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(q + t * q_t + d));
    return pack2(f.x * scale, f.y * scale);
  };
  uint32_t qf[HDP / 16][4];
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const int d = kk * 16 + qc;
    qf[kk][0] = load_q(t0, d);
    qf[kk][1] = load_q(t1, d);
    qf[kk][2] = load_q(t0, d + 8);
    qf[kk][3] = load_q(t1, d + 8);
  }

  float o[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int kv0 = 0; kv0 < S; kv0 += BKV) {
    // stage K row-major and V transposed (V^T rows are the B operand of P V)
    for (int idx = tid; idx < BKV * HD / 8; idx += THREADS) {
      const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8, t = kv0 + r;
      uint4 kv = zero, vv = zero;
      if (t < S) {
        kv = *reinterpret_cast<const uint4*>(k + t * k_t + c);
        vv = *reinterpret_cast<const uint4*>(v + t * v_t + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * K_LD + c) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c + j) * VT_LD + r] = ve[j];
    }
    __syncthreads();

    // scores: Q (16 x HDP) @ K^T (HDP x 64), eight 16 x 8 tiles
    float s[BKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt)
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk)
#pragma unroll
      for (int nt = 0; nt < BKV / 8; ++nt) {
        const bf16* kp = Ks + (nt * 8 + qr) * K_LD + kk * 16 + qc;
        const uint32_t b[2] = {ld32(kp), ld32(kp + 8)};
        mma_16816(s[nt], qf[kk], b);
      }

    // key mask and online softmax; exp(x) = exp2(x * log2 e)
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool live = kv0 + nt * 8 + qc + e < S;
        s[nt][e] = live ? s[nt][e] * LOG2E : -CUDART_INF_F;
        s[nt][2 + e] = live ? s[nt][2 + e] * LOG2E : -CUDART_INF_F;
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
      *reinterpret_cast<uint32_t*>(out + t0 * o_t + d) =
          pack2(o[dt][0] * inv0, o[dt][1] * inv0);
    if (t1 < S)
      *reinterpret_cast<uint32_t*>(out + t1 * o_t + d) =
          pack2(o[dt][2] * inv1, o[dt][3] * inv1);
  }
}

}  // namespace

extern "C" int flmm_plain_flash(const void* q, long long q_b, long long q_h,
                                long long q_t, const void* k, long long k_b,
                                long long k_h, long long k_t, const void* v,
                                long long v_b, long long v_h, long long v_t,
                                int nh, int G, int S, int head_dim,
                                float scale, void* out, long long o_b,
                                long long o_h, long long o_t, void* stream) {
  if (G <= 0 || S <= 0 || nh <= 0 || G > 65535 || q_b % 8 || q_h % 8 ||
      q_t % 8 || k_b % 8 || k_h % 8 || k_t % 8 || v_b % 8 || v_h % 8 ||
      v_t % 8 || o_b % 2 || o_h % 2 || o_t % 2)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((S + BQ - 1) / BQ, G);
  const cudaStream_t s = (cudaStream_t)stream;
#define FLMM_PLAIN_FLASH(HD)                                                \
  plain_flash_kernel<HD><<<grid, THREADS, 0, s>>>(                          \
      (const bf16*)q, q_b, q_h, q_t, (const bf16*)k, k_b, k_h, k_t,         \
      (const bf16*)v, v_b, v_h, v_t, nh, S, scale, (bf16*)out, o_b, o_h, o_t)
  if (head_dim == 64) FLMM_PLAIN_FLASH(64);
  else if (head_dim == 72) FLMM_PLAIN_FLASH(72);
  else return (int)cudaErrorInvalidValue;
#undef FLMM_PLAIN_FLASH
  return (int)cudaGetLastError();
}
