// Transformer block tail: x = s + a @ wo + bo;  out = x + W2 act(W1 LN(x) + b1) + b2.
//
// Replaces flmm_tpu/ops/fused_block.py::fused_proj_ln_mlp (K4, the
// pallas_call at :154) and serves the out-proj + LN2 + MLP stage of
// flmm_tpu/ops/window_block.py::window_block (K1).
//
// What bounds it on an H100: per row it does 2 (C^2 + 2 C F) FLOP (18.9
// MFLOP at C = 1024, F = 4096) and its only mandatory traffic is the two
// bf16 input rows and the output row, so it is tensor-core bound once the
// (N, F) hidden activation stays on chip -- which is what the TPU kernel
// was for.  The TPU kernel carried the F reduction across a sequential grid
// axis in scratch (fused_block.py:56-78); blocks on Hopper run in no order,
// so here one block owns BM = 32 whole rows and loops over F itself:
//
//   1. the attention rows are staged in shared memory and a @ wo is
//      accumulated in registers (each of 16 warps owns 64 output columns);
//      the shortcut and bo are added in an f32 shared tile X (32 x C);
//   2. LN(x) is written to shared memory in bf16 (32 x C);
//   3. for each chunk of 128 hidden units: h = act(LN(x) @ W1[:, chunk] + b1)
//      goes to shared memory in bf16, then acc += h @ W2[chunk, :], where
//      acc restarted from x -- the hidden never reaches device memory;
//   4. out = acc + b2, rounded once to bf16.
//
// The weights stream through shared memory in slices (16 x C of wo and W2,
// 64 x 128 of W1) with cp.async, double-buffered in the part of the 223 KB
// that X does not need at the time, so the next slice is in flight while
// the tensor cores use the current one.  The price of whole rows per block
// is that every block reads all 18 MB of weights (from L2) for 32 rows,
// which bounds the kernel near the cuBLAS time of the three unfused
// products; a cluster split of the output columns (DSMEM) and wgmma are the
// next steps.  Activations: the four of fused_block._ACTS, with CUDA's erff
// for the exact-erf GELU.
//
// The same kernel without step 1 (PROJ = false: X is the input rows) is
// the LN2 + MLP + residual of flmm_tpu/ops/fused_block.py::fused_ln_mlp
// (K8, the pallas_call at :264), its own entry point flmm_ln_mlp: per row
// 4 C F FLOP (16.8 MFLOP), one bf16 row in and one out, so the tensor cores
// bound it as they bound K4, and the same 16 MB of W1 and W2 per 32 rows
// come from L2.
#include "common.cuh"

namespace {

constexpr int C = 1024, BM = 32, BF = 128, WARPS = 16, THREADS = WARPS * 32;
constexpr int XS_LD = C + 4, LS_LD = C + 8, HS_LD = BF + 4, HB_LD = BF + 8;
constexpr int WCOLS = C / WARPS, NFRAG = WCOLS / 16;
constexpr int WIDE_K = 16, NARROW_K = 64;   // rows per weight slice
constexpr int WIDE_LD = C + 8, NARROW_LD = BF + 8;
constexpr size_t XS_BYTES = (size_t)BM * XS_LD * 4;
constexpr size_t LS_BYTES = (size_t)BM * LS_LD * 2;
constexpr size_t HS_BYTES = (size_t)BM * HS_LD * 4;
constexpr size_t HB_BYTES = (size_t)BM * HB_LD * 2;
constexpr size_t SMEM = XS_BYTES + LS_BYTES + HS_BYTES + HB_BYTES;
// weight slices live inside the X region while X is not in use
constexpr size_t WIDE_BYTES = (size_t)WIDE_K * WIDE_LD * 2;
constexpr size_t NARROW_BYTES = (size_t)NARROW_K * NARROW_LD * 2;
static_assert(2 * WIDE_BYTES + 2 * NARROW_BYTES <= XS_BYTES, "slices fit in X");

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> AFrag;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> BFrag;

// Rows [k0, k0 + ROWS) and columns [c0, c0 + WIDTH) of a row-major matrix
// with leading dimension ld -> shared memory (leading dimension sld), as one
// cp.async group.
template <int ROWS, int WIDTH>
__device__ __forceinline__ void issue_slice(bf16* dst, int sld,
                                            const bf16* src, int ld, int k0,
                                            int c0, int tid) {
  constexpr int VPR = WIDTH / 8;
#pragma unroll
  for (int idx = tid; idx < ROWS * VPR; idx += THREADS) {
    const int r = idx / VPR, c = (idx % VPR) * 8;
    cp_async16(dst + r * sld + c, src + (size_t)(k0 + r) * ld + c0 + c);
  }
  cp_async_commit();
}

// Wait for every slice but the one issued last (or for all of them).
__device__ __forceinline__ void wait_slices(bool one_newer_in_flight) {
  if (one_newer_in_flight) cp_async_wait<1>();
  else cp_async_wait<0>();
  __syncthreads();
}

template <int ACT, bool PROJ>
__global__ void __launch_bounds__(THREADS, 1)
block_tail_kernel(const bf16* __restrict__ shortcut,
                  const bf16* __restrict__ attn, int N, int F,
                  const bf16* __restrict__ wo, const bf16* __restrict__ bo,
                  const bf16* __restrict__ ln_w, const bf16* __restrict__ ln_b,
                  float eps, const bf16* __restrict__ w1,
                  const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                  const bf16* __restrict__ b2, bf16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Xs = reinterpret_cast<float*>(smem);
  bf16* wide[2] = {reinterpret_cast<bf16*>(smem),
                   reinterpret_cast<bf16*>(smem + WIDE_BYTES)};
  bf16* narrow[2] = {reinterpret_cast<bf16*>(smem + 2 * WIDE_BYTES),
                     reinterpret_cast<bf16*>(smem + 2 * WIDE_BYTES + NARROW_BYTES)};
  bf16* Ls = reinterpret_cast<bf16*>(smem + XS_BYTES);
  float* Hs = reinterpret_cast<float*>(smem + XS_BYTES + LS_BYTES);
  bf16* Hb = reinterpret_cast<bf16*>(smem + XS_BYTES + LS_BYTES + HS_BYTES);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.x * BM;
  const int rows = min(BM, N - r0);
  const int col0 = warp * WCOLS;

  AccFrag acc[2][NFRAG];
  if constexpr (PROJ) {
    // 1. acc = attn @ wo: attention rows (zeros past N) and the first wo
    //    slice in flight together
    for (int idx = tid; idx < BM * C / 8; idx += THREADS) {
      const int r = idx / (C / 8), c = (idx % (C / 8)) * 8;
      if (r < rows)
        cp_async16(Ls + r * LS_LD + c, attn + (size_t)(r0 + r) * C + c);
      else
        *reinterpret_cast<uint4*>(Ls + r * LS_LD + c) = make_uint4(0, 0, 0, 0);
    }
    cp_async_commit();
    issue_slice<WIDE_K, C>(wide[0], WIDE_LD, wo, C, 0, 0, tid);

    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < NFRAG; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    constexpr int WO_SLICES = C / WIDE_K;
    for (int t = 0; t < WO_SLICES; ++t) {
      const bool more = t + 1 < WO_SLICES;
      if (more)
        issue_slice<WIDE_K, C>(wide[(t + 1) & 1], WIDE_LD, wo, C,
                               (t + 1) * WIDE_K, 0, tid);
      wait_slices(more);
      AFrag a[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], Ls + i * 16 * LS_LD + t * WIDE_K, LS_LD);
      for (int j = 0; j < NFRAG; ++j) {
        BFrag b;
        wmma::load_matrix_sync(b, wide[t & 1] + col0 + j * 16, WIDE_LD);
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
      __syncthreads();
    }
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < NFRAG; ++j)
        wmma::store_matrix_sync(Xs + i * 16 * XS_LD + col0 + j * 16, acc[i][j],
                                XS_LD, wmma::mem_row_major);
    __syncthreads();
    for (int idx = tid; idx < BM * C; idx += THREADS) {
      const int r = idx / C, c = idx % C;
      const float s =
          r < rows ? __bfloat162float(shortcut[(size_t)(r0 + r) * C + c]) : 0.f;
      Xs[r * XS_LD + c] += s + __bfloat162float(bo[c]);
    }
  } else {
    // 1'. no projection: X is the input rows (zeros past N)
    for (int idx = tid; idx < BM * C; idx += THREADS) {
      const int r = idx / C, c = idx % C;
      Xs[r * XS_LD + c] =
          r < rows ? __bfloat162float(shortcut[(size_t)(r0 + r) * C + c]) : 0.f;
    }
  }
  __syncthreads();

  // 2. LN(x) -> Ls (bf16); acc restarts from x for the final residual
  for (int r = warp; r < BM; r += WARPS) {
    const float* xr = Xs + r * XS_LD;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += xr[c];
    const float mu = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = xr[c] - mu;
      v += d * d;
    }
    const float rs = rsqrtf(warp_sum(v) / C + eps);
    for (int c = lane; c < C; c += 32)
      Ls[r * LS_LD + c] = __float2bfloat16(
          (xr[c] - mu) * rs * __bfloat162float(ln_w[c]) +
          __bfloat162float(ln_b[c]));
  }
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < NFRAG; ++j)
      wmma::load_matrix_sync(acc[i][j], Xs + i * 16 * XS_LD + col0 + j * 16,
                             XS_LD, wmma::mem_row_major);
  __syncthreads();  // from here X holds weight slices

  // 3. MLP over F in chunks of BF hidden units
  const int hr = (warp / 8) * 16, hc = (warp % 8) * 16;
  constexpr int W1_SLICES = C / NARROW_K, W2_SLICES = BF / WIDE_K;
  issue_slice<NARROW_K, BF>(narrow[0], NARROW_LD, w1, F, 0, 0, tid);
  for (int f0 = 0; f0 < F; f0 += BF) {
    AccFrag h;
    wmma::fill_fragment(h, 0.f);
    for (int t = 0; t < W1_SLICES; ++t) {
      if (t + 1 < W1_SLICES)
        issue_slice<NARROW_K, BF>(narrow[(t + 1) & 1], NARROW_LD, w1, F,
                                  (t + 1) * NARROW_K, f0, tid);
      else  // the first W2 slice of this chunk
        issue_slice<WIDE_K, C>(wide[0], WIDE_LD, w2, C, f0, 0, tid);
      wait_slices(true);
      for (int kk = 0; kk < NARROW_K; kk += 16) {
        AFrag a;
        BFrag b;
        wmma::load_matrix_sync(a, Ls + hr * LS_LD + t * NARROW_K + kk, LS_LD);
        wmma::load_matrix_sync(b, narrow[t & 1] + kk * NARROW_LD + hc,
                               NARROW_LD);
        wmma::mma_sync(h, a, b, h);
      }
      __syncthreads();
    }
    wmma::store_matrix_sync(Hs + hr * HS_LD + hc, h, HS_LD, wmma::mem_row_major);
    __syncthreads();
    for (int idx = tid; idx < BM * BF; idx += THREADS) {
      const int r = idx / BF, c = idx % BF;
      Hb[r * HB_LD + c] = __float2bfloat16(activate<ACT>(
          Hs[r * HS_LD + c] + __bfloat162float(b1[f0 + c])));
    }
    // (the barrier inside the first wait_slices below orders Hb)
    for (int t = 0; t < W2_SLICES; ++t) {
      bool issued = true;
      if (t + 1 < W2_SLICES)
        issue_slice<WIDE_K, C>(wide[(t + 1) & 1], WIDE_LD, w2, C,
                               f0 + (t + 1) * WIDE_K, 0, tid);
      else if (f0 + BF < F)  // the first W1 slice of the next chunk
        issue_slice<NARROW_K, BF>(narrow[0], NARROW_LD, w1, F, 0, f0 + BF,
                                  tid);
      else
        issued = false;
      wait_slices(issued);
      AFrag a[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], Hb + i * 16 * HB_LD + t * WIDE_K, HB_LD);
      for (int j = 0; j < NFRAG; ++j) {
        BFrag b;
        wmma::load_matrix_sync(b, wide[t & 1] + col0 + j * 16, WIDE_LD);
        for (int i = 0; i < 2; ++i)
          wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
      __syncthreads();
    }
  }

  // 4. out = x + MLP(x) + b2
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < NFRAG; ++j)
      wmma::store_matrix_sync(Xs + i * 16 * XS_LD + col0 + j * 16, acc[i][j],
                              XS_LD, wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * C; idx += THREADS) {
    const int r = idx / C, c = idx % C;
    if (r < rows)
      out[(size_t)(r0 + r) * C + c] =
          __float2bfloat16(Xs[r * XS_LD + c] + __bfloat162float(b2[c]));
  }
}

template <int ACT, bool PROJ>
int launch(const void* shortcut, const void* attn, int N, int F,
           const void* wo, const void* bo, const void* ln_w, const void* ln_b,
           float eps, const void* w1, const void* b1, const void* w2,
           const void* b2, void* out, cudaStream_t stream) {
  auto kernel = block_tail_kernel<ACT, PROJ>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(N + BM - 1) / BM, THREADS, SMEM, stream>>>(
      (const bf16*)shortcut, (const bf16*)attn, N, F, (const bf16*)wo,
      (const bf16*)bo, (const bf16*)ln_w, (const bf16*)ln_b, eps,
      (const bf16*)w1, (const bf16*)b1, (const bf16*)w2, (const bf16*)b2,
      (bf16*)out);
  return (int)cudaGetLastError();
}

template <bool PROJ>
int dispatch(const void* shortcut, const void* attn, int N, int channels,
             int F, const void* wo, const void* bo, const void* ln_w,
             const void* ln_b, float eps, const void* w1, const void* b1,
             const void* w2, const void* b2, int act, void* out,
             void* stream) {
  if (N <= 0 || channels != C || F <= 0 || F % BF != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (act) {
    case ACT_GELU:
      return launch<ACT_GELU, PROJ>(shortcut, attn, N, F, wo, bo, ln_w, ln_b,
                                    eps, w1, b1, w2, b2, out, s);
    case ACT_GELU_TANH:
      return launch<ACT_GELU_TANH, PROJ>(shortcut, attn, N, F, wo, bo, ln_w,
                                         ln_b, eps, w1, b1, w2, b2, out, s);
    case ACT_QUICK_GELU:
      return launch<ACT_QUICK_GELU, PROJ>(shortcut, attn, N, F, wo, bo, ln_w,
                                          ln_b, eps, w1, b1, w2, b2, out, s);
    case ACT_RELU:
      return launch<ACT_RELU, PROJ>(shortcut, attn, N, F, wo, bo, ln_w, ln_b,
                                    eps, w1, b1, w2, b2, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flmm_block_tail(const void* shortcut, const void* attn, int N,
                               int channels, int F, const void* wo,
                               const void* bo, const void* ln_w,
                               const void* ln_b, float eps, const void* w1,
                               const void* b1, const void* w2, const void* b2,
                               int act, void* out, void* stream) {
  return dispatch<true>(shortcut, attn, N, channels, F, wo, bo, ln_w, ln_b,
                        eps, w1, b1, w2, b2, act, out, stream);
}

// K8: out = x + W2 act(W1 LN(x) + b1) + b2 over (N, C) rows.
extern "C" int flmm_ln_mlp(const void* x, int N, int channels, int F,
                           const void* ln_w, const void* ln_b, float eps,
                           const void* w1, const void* b1, const void* w2,
                           const void* b2, int act, void* out, void* stream) {
  return dispatch<false>(x, nullptr, N, channels, F, nullptr, nullptr, ln_w,
                         ln_b, eps, w1, b1, w2, b2, act, out, stream);
}
