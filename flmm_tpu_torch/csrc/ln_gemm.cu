// LayerNorm-prologue GEMM: out = LN(A)[row_valid] @ B + bias.
//
// Replaces flmm_tpu/ops/fused_block.py::fused_ln_qkv (K3, the pallas_call
// at :220) and serves the LN1 + qkv stage of
// flmm_tpu/ops/window_block.py::window_block (K1), whose masked LayerNorm
// zeroes the normed rows of geometric pad tokens so they project to the
// bias alone (window_block.py:41-47).
//
// What bounds it on an H100: at the slice shapes (M = 2304..19600 rows,
// K = 1024, N = 3072) the product does ~300 FLOP per byte it must read,
// so it is tensor-core bound.  What the design keeps from the TPU kernel is
// the fusion: the normed activations never reach device memory.
//
//   1. ln_stats_kernel: one warp per row, two f32 passes (mean, then the
//      centred variance, as the JAX kernel computes them), 8 bytes per row
//      written to a scratch buffer the wrapper allocates;
//   2. ln_gemm_kernel: 128 x 128 output tiles, 8 warps of 64 x 32, K in
//      slices of 32.  Each thread fetches its part of the next A and B
//      slices as 16-byte vectors into registers while the tensor cores
//      work on the current slice; the A part is normalised (and zeroed for
//      pad rows) in registers on its way into shared memory.  Two shared
//      buffers, one barrier per slice.  WMMA 16x16x16 bf16 fragments with
//      f32 accumulation; the epilogue adds the bias and rounds once.
//
// The same tiles without the LayerNorm prologue and with an f32 epilogue,
// out = resid + A @ B + bias (entry point flmm_gemm_residual_f32), are the
// last phase of flmm_tpu/ops/global_block.py::global_attn_block (K10): the
// output projection of all heads added to the residual in f32 and written
// unrounded.  One block owns an output tile and walks K in a fixed order,
// so the sum over the heads has one order and no atomics.
//
// Not yet: wgmma, TMA, deeper pipelines -- the next steps toward the
// tensor-core bound.
#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 32, THREADS = 256;
constexpr int AS_LD = BK + 8, BS_LD = BN + 8;
constexpr int A_VECS = BM * BK / 8 / THREADS;  // 16-byte vectors per thread
constexpr int B_VECS = BK * BN / 8 / THREADS;
constexpr int STATS_ROWS = 8;                  // rows (warps) per stats block

__global__ void __launch_bounds__(STATS_ROWS * 32)
ln_stats_kernel(const bf16* __restrict__ A, int M, int K, float eps,
                float2* __restrict__ stats) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * STATS_ROWS + warp;
  if (row >= M) return;
  const bf16* r = A + (size_t)row * K;
  float f[8], s = 0.f;
  for (int c = lane * 8; c < K; c += 256) {
    unpack8(*reinterpret_cast<const uint4*>(r + c), f);
    for (int i = 0; i < 8; ++i) s += f[i];
  }
  const float mu = warp_sum(s) / K;
  float v = 0.f;
  for (int c = lane * 8; c < K; c += 256) {
    unpack8(*reinterpret_cast<const uint4*>(r + c), f);
    for (int i = 0; i < 8; ++i) v += (f[i] - mu) * (f[i] - mu);
  }
  const float rs = rsqrtf(warp_sum(v) / K + eps);
  if (lane == 0) stats[row] = make_float2(mu, rs);
}

// LN: normalise A's rows on their way into shared memory.  RESID: the
// epilogue adds the bf16 rows of resid and writes f32 to out_f32; else it
// rounds to bf16 into out.
template <bool LN, bool RESID>
__global__ void __launch_bounds__(THREADS)
ln_gemm_kernel(const bf16* __restrict__ A, int M, int K,
               const float2* __restrict__ stats,
               const bf16* __restrict__ ln_w, const bf16* __restrict__ ln_b,
               const unsigned char* __restrict__ row_valid,
               const bf16* __restrict__ B, int N,
               const bf16* __restrict__ bias, bf16* __restrict__ out,
               const bf16* __restrict__ resid, float* __restrict__ out_f32) {
  __shared__ __align__(128) bf16 As[2][BM * AS_LD];
  __shared__ __align__(128) bf16 Bs[2][BK * BS_LD];
  __shared__ __align__(128) float scratch[THREADS / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // This thread's A vectors: fixed rows, so their statistics are loaded
  // once; a pad row (or a row past M) stages zeros.
  int a_row[A_VECS], a_col[A_VECS];
  float a_mu[A_VECS], a_rs[A_VECS];
  bool a_live[A_VECS];
#pragma unroll
  for (int i = 0; i < A_VECS; ++i) {
    const int idx = tid + i * THREADS;
    a_row[i] = idx / (BK / 8);
    a_col[i] = (idx % (BK / 8)) * 8;
    const int gr = m0 + a_row[i];
    a_live[i] = gr < M && (row_valid == nullptr || row_valid[gr]);
    const float2 st = LN && a_live[i] ? stats[gr] : make_float2(0.f, 0.f);
    a_mu[i] = st.x;
    a_rs[i] = st.y;
  }
  int b_row[B_VECS], b_col[B_VECS];
#pragma unroll
  for (int i = 0; i < B_VECS; ++i) {
    const int idx = tid + i * THREADS;
    b_row[i] = idx / (BN / 8);
    b_col[i] = (idx % (BN / 8)) * 8;
  }
  const uint4 zero = make_uint4(0, 0, 0, 0);
  uint4 ra[A_VECS], rb[B_VECS];

  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i)
      ra[i] = a_live[i] ? *reinterpret_cast<const uint4*>(
                              A + (size_t)(m0 + a_row[i]) * K + k0 + a_col[i])
                        : zero;
#pragma unroll
    for (int i = 0; i < B_VECS; ++i) {
      const int gc = n0 + b_col[i];
      rb[i] = gc < N ? *reinterpret_cast<const uint4*>(
                           B + (size_t)(k0 + b_row[i]) * N + gc)
                     : zero;
    }
  };
  auto stage = [&](int k0, int buf) {
#pragma unroll
    for (int i = 0; i < A_VECS; ++i) {
      uint4 v = zero;
      if (!LN) {
        v = ra[i];  // zero where not live
      } else if (a_live[i]) {
        float x[8], w[8], b[8];
        unpack8(ra[i], x);
        unpack8(*reinterpret_cast<const uint4*>(ln_w + k0 + a_col[i]), w);
        unpack8(*reinterpret_cast<const uint4*>(ln_b + k0 + a_col[i]), b);
        for (int j = 0; j < 8; ++j) x[j] = (x[j] - a_mu[i]) * a_rs[i] * w[j] + b[j];
        v = pack8(x);
      }
      *reinterpret_cast<uint4*>(&As[buf][a_row[i] * AS_LD + a_col[i]]) = v;
    }
#pragma unroll
    for (int i = 0; i < B_VECS; ++i)
      *reinterpret_cast<uint4*>(&Bs[buf][b_row[i] * BS_LD + b_col[i]]) = rb[i];
  };

  const int wr = warp / 4, wc = warp % 4;  // warp tile: rows wr*64, cols wc*32
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int KT = K / BK;
  fetch(0);
  stage(0, 0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT) fetch((kt + 1) * BK);
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], &As[cur][(wr * 64 + i * 16) * AS_LD + kk],
                               AS_LD);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[cur][kk * BS_LD + wc * 32 + j * 16],
                               BS_LD);
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < KT) stage((kt + 1) * BK, cur ^ 1);
    __syncthreads();
  }

  // Epilogue, one 16x16 fragment at a time through this warp's scratch:
  // + bias, one rounding to bf16, 16-byte stores.
  float* sc = scratch[warp];
  const int er = lane / 2, ec = (lane % 2) * 8;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wr * 64 + i * 16 + er;
      const int gc = n0 + wc * 32 + j * 16 + ec;
      if (gr < M && gc < N) {
        float v[8], bv[8];
        unpack8(*reinterpret_cast<const uint4*>(bias + gc), bv);
        for (int t = 0; t < 8; ++t) v[t] = sc[er * 16 + ec + t] + bv[t];
        if constexpr (RESID) {
          float rv[8];
          unpack8(*reinterpret_cast<const uint4*>(resid + (size_t)gr * N + gc),
                  rv);
          for (int t = 0; t < 8; ++t) v[t] += rv[t];
          float4* o = reinterpret_cast<float4*>(out_f32 + (size_t)gr * N + gc);
          o[0] = make_float4(v[0], v[1], v[2], v[3]);
          o[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
          *reinterpret_cast<uint4*>(out + (size_t)gr * N + gc) = pack8(v);
        }
      }
      __syncwarp();
    }
}

}  // namespace

extern "C" int flmm_ln_gemm(const void* A, int M, int K, const void* ln_w,
                            const void* ln_b, float eps, const void* row_valid,
                            const void* B, int N, const void* bias, void* out,
                            void* stats, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BK != 0 || N % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  ln_stats_kernel<<<(M + STATS_ROWS - 1) / STATS_ROWS, STATS_ROWS * 32, 0, s>>>(
      (const bf16*)A, M, K, eps, (float2*)stats);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  ln_gemm_kernel<true, false><<<grid, THREADS, 0, s>>>(
      (const bf16*)A, M, K, (const float2*)stats, (const bf16*)ln_w,
      (const bf16*)ln_b, (const unsigned char*)row_valid, (const bf16*)B, N,
      (const bf16*)bias, (bf16*)out, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// out (M, N) f32 = resid (M, N) + A (M, K) @ B (K, N) + bias (N).
extern "C" int flmm_gemm_residual_f32(const void* A, int M, int K,
                                      const void* B, int N, const void* bias,
                                      const void* resid, void* out,
                                      void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BK != 0 || N % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  ln_gemm_kernel<false, true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)A, M, K, nullptr, nullptr, nullptr, nullptr,
      (const bf16*)B, N, (const bf16*)bias, nullptr, (const bf16*)resid,
      (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* flmm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
