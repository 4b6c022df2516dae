// Window attention with decomposed relative-position bias over SPATIAL,
// head-major qkv, softmax in base 2.
//
// Replaces flmm_tpu/ops/sam_flash_experiments.py::sam_window_attention_v10
// (K12 v10, the pallas_call at :1222).  qkv is (B, Hp, Wp, nh * 3 * 64)
// with Hp, Wp multiples of side and each token's columns laid out
// [q_h | k_h | v_h] per head; the output is (B, Hp, Wp, nh * 64).  Per
// (image, window, head):
//
//   score(i, j) = round(q_i * scale * log2(e)) . k_j
//                 + round(bias[i, j / side]) + round(bias[i, side + j % side])
//
// with the f32 bias rows (B, nwy, nwx, nh, T, 2 * side), already times
// log2(e), made outside from the unscaled q as the JAX wrapper makes them,
// and round() the rounding to bf16 that the TPU kernel applies to both
// operands of its augmented product.  Keys whose spatial position is at or
// beyond grid_hw are masked OUT of the softmax (unlike K1 and K6, where pad
// tokens stay in it with k = b_k), p = exp2(score - max), and each head's 64
// columns are written back at the token's spatial position.  Tokens at or
// beyond grid_hw get 0 (the TPU kernel leaves that region unspecified).
//
// What bounds it on an H100: at bs 8 (200 windows x 16 heads of T = 196)
// the two products are 31.5 GFLOP (0.03 ms at the bf16 peak) against 321 MB
// of qkv and output (0.10 ms), so the bytes bound it; what keeps it above
// that bound is the core's staging, not the tensor cores.  The TPU gets the
// window partition from a BlockSpec and the head split from lane slices;
// here a block computes its own offsets: token t of window (wy, wx) lies at row
// (wy * side + t / side) * Wp + wx * side + t % side, a two-level stride
// that the one-token-stride launch of relpos_attention.cu cannot express,
// hence a source of its own.  The core is that kernel's: a block owns 64
// query rows of one (image, window, head), 4 warps of 16 rows, scores,
// probabilities and the f32 output accumulator in registers (raw
// mma.sync.m16n8k16), 64-key tiles of K and V^T in shared memory.  q, k and
// v of one token and head are 384 contiguous bytes, so every load is a
// 16-byte vector; nothing is windowised, transposed or copied outside.
// Not yet: a 196-row tiling (4 query blocks of 64 waste 23% of the rows),
// load/compute overlap, wgmma.
#include "common.cuh"

namespace {

constexpr int HD = 64, BQ = 64, BKV = 64, WARPS = 4, THREADS = WARPS * 32;
constexpr int K_LD = HD + 8;      // Ks[key][d]
constexpr int VT_LD = BKV + 8;    // Vt[d][key]
constexpr int MAX_SIDE = HD / 2;  // 2 * side <= head_dim, as the JAX wrapper

struct Shape {
  int Hp, Wp, nh, side, grid_hw, nwy, nwx, n_qb;
};

// One bf16x2 register scaled in f32 and rounded back.
__device__ __forceinline__ uint32_t scale_pair(uint32_t raw, float s) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
  return pack2(f.x * s, f.y * s);
}

__global__ void __launch_bounds__(THREADS)
spatial_window_attention_kernel(const bf16* __restrict__ qkv,
                                const float* __restrict__ bias, Shape sh,
                                float scale2, bf16* __restrict__ out) {
  __shared__ __align__(16) bf16 Ks[BKV * K_LD];
  __shared__ __align__(16) bf16 Vt[HD * VT_LD];
  __shared__ float Bsm[BQ * 2 * MAX_SIDE];
  __shared__ unsigned char kok[BKV];

  const int side = sh.side, T = side * side, two_side = 2 * side;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = (blockIdx.x % sh.n_qb) * BQ;
  const long long g = blockIdx.x / sh.n_qb;  // ((b*nwy + wy)*nwx + wx)*nh + h
  const int h = (int)(g % sh.nh);
  const long long w = g / sh.nh;
  const int wx = (int)(w % sh.nwx), wy = (int)((w / sh.nwx) % sh.nwy);
  const long long b = w / ((long long)sh.nwx * sh.nwy);
  const int y0 = wy * side, x0 = wx * side;
  const long long row_in = (long long)sh.nh * 3 * HD;
  const long long row_out = (long long)sh.nh * HD;
  const bf16* in = qkv + b * sh.Hp * sh.Wp * row_in + h * 3 * HD;
  bf16* op = out + b * sh.Hp * sh.Wp * row_out + h * HD;

  // token t of this window -> its token index in the (Hp, Wp) grid
  auto spatial = [&](int t) {
    return (long long)(y0 + t / side) * sh.Wp + x0 + t % side;
  };
  auto inside = [&](int t) {
    return y0 + t / side < sh.grid_hw && x0 + t % side < sh.grid_hw;
  };

  for (int idx = tid; idx < BQ * two_side; idx += THREADS) {
    const int r = idx / two_side, j = idx % two_side, t = q0 + r;
    Bsm[idx] = t < T
        ? __bfloat162float(__float2bfloat16(
              bias[(g * T + t) * two_side + j])) : 0.f;
  }

  // This thread's two query rows (fragment rows lane/4 and lane/4 + 8) and
  // column pair (lane%4)*2; Q fragments straight from device memory, scaled
  // in f32 and rounded.
  const int qr = lane / 4, qc = (lane % 4) * 2;
  const int t0 = q0 + warp * 16 + qr, t1 = t0 + 8;
  const bool in0 = t0 < T, in1 = t1 < T;
  const bf16* qp0 = in + (in0 ? spatial(t0) : 0) * row_in;
  const bf16* qp1 = in + (in1 ? spatial(t1) : 0) * row_in;
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int d = kk * 16 + qc;
    qf[kk][0] = in0 ? scale_pair(ld32(qp0 + d), scale2) : 0u;
    qf[kk][1] = in1 ? scale_pair(ld32(qp1 + d), scale2) : 0u;
    qf[kk][2] = in0 ? scale_pair(ld32(qp0 + d + 8), scale2) : 0u;
    qf[kk][3] = in1 ? scale_pair(ld32(qp1 + d + 8), scale2) : 0u;
  }

  float o[HD / 8][4];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  const float* brow0 = Bsm + (warp * 16 + qr) * two_side;
  const float* brow1 = brow0 + 8 * two_side;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int kv0 = 0; kv0 < T; kv0 += BKV) {
    // stage K row-major and V transposed (V^T rows are the B operand of P V)
    for (int idx = tid; idx < BKV * HD / 8; idx += THREADS) {
      const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8, t = kv0 + r;
      uint4 kv = zero, vv = zero;
      if (t < T) {
        const bf16* tp = in + spatial(t) * row_in;
        kv = *reinterpret_cast<const uint4*>(tp + HD + c);
        vv = *reinterpret_cast<const uint4*>(tp + 2 * HD + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * K_LD + c) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c + j) * VT_LD + r] = ve[j];
    }
    if (tid < BKV) kok[tid] = kv0 + tid < T && inside(kv0 + tid);
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
        const uint32_t bfr[2] = {ld32(kp), ld32(kp + 8)};
        mma_16816(s[nt], qf[kk], bfr);
      }

    // bias, key mask, online softmax in base 2
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kl = nt * 8 + qc + e, key = kv0 + kl;
        if (kok[kl]) {
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
    // a row with no unmasked key so far keeps p = 0 (exp2(-inf - 0)) and
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
        const bf16* vp = Vt + (dt * 8 + qr) * VT_LD + j * 16 + qc;
        const uint32_t bfr[2] = {ld32(vp), ld32(vp + 8)};
        mma_16816(o[dt], a, bfr);
      }
    }
    __syncthreads();  // K, V^T and the key flags are restaged next
  }

  // tokens beyond the valid grid are written as 0
  const float L0 = quad_sum(l0), L1 = quad_sum(l1);
  const float inv0 = in0 && inside(t0) ? 1.f / fmaxf(L0, 1e-30f) : 0.f;
  const float inv1 = in1 && inside(t1) ? 1.f / fmaxf(L1, 1e-30f) : 0.f;
  bf16* op0 = op + (in0 ? spatial(t0) : 0) * row_out;
  bf16* op1 = op + (in1 ? spatial(t1) : 0) * row_out;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int d = dt * 8 + qc;
    if (in0)
      *reinterpret_cast<uint32_t*>(op0 + d) =
          pack2(o[dt][0] * inv0, o[dt][1] * inv0);
    if (in1)
      *reinterpret_cast<uint32_t*>(op1 + d) =
          pack2(o[dt][2] * inv1, o[dt][3] * inv1);
  }
}

}  // namespace

extern "C" int flmm_spatial_window_attention(const void* qkv, const void* bias,
                                             int B, int Hp, int Wp, int nh,
                                             int head_dim, int side,
                                             int grid_hw, float scale2,
                                             void* out, void* stream) {
  if (head_dim != HD || B <= 0 || nh <= 0 || side <= 0 || side > MAX_SIDE ||
      Hp <= 0 || Wp <= 0 || Hp % side || Wp % side || grid_hw <= 0 ||
      grid_hw > Hp || grid_hw > Wp)
    return (int)cudaErrorInvalidValue;
  const int T = side * side;
  const Shape sh{Hp, Wp, nh, side, grid_hw, Hp / side, Wp / side,
                 (T + BQ - 1) / BQ};
  const long long blocks = (long long)B * sh.nwy * sh.nwx * nh * sh.n_qb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  spatial_window_attention_kernel<<<(unsigned)blocks, THREADS, 0,
                                    (cudaStream_t)stream>>>(
      (const bf16*)qkv, (const float*)bias, sh, scale2, (bf16*)out);
  return (int)cudaGetLastError();
}
