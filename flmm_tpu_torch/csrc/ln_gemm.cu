// LayerNorm-prologue GEMM: out = LN(A)[row_valid] @ B + bias.
//
// Replaces flmm_tpu/ops/fused_block.py::fused_ln_qkv (K3, the pallas_call
// at :220) and serves the LN1 + qkv stage of
// flmm_tpu/ops/window_block.py::window_block (K1), whose masked LayerNorm
// zeroes the normed rows of geometric pad tokens so they project to the
// bias alone (window_block.py:41-47).
//
// What bounds it on an H100: at the slice shapes (M = 2304..19600 rows,
// K = 768..1280, N = 3K) the product does ~300 FLOP per byte it must read,
// so it is tensor-core bound.  Two launches on the GEMM core of
// csrc/gemm_sm90.cuh: the LayerNorm row pass writes LN(A) in bf16 (zeroed
// pad rows), then the wgmma + TMA product adds the bias and rounds once.
// The TPU kernel kept the normed rows out of device memory; here they make
// one bf16 round trip (2 x 40 MB at 19,600 rows of 1024, ~25 us at the
// memory rate), the price of feeding wgmma from TMA-written tiles as they
// land.
//
// The same product with an f32 epilogue, out = resid + A @ B + bias (entry
// point flmm_gemm_residual_f32), is the last phase of
// flmm_tpu/ops/global_block.py::global_attn_block (K10): the output
// projection of all heads added to the residual in f32 and written
// unrounded.  One block owns an output tile and walks K in a fixed order,
// so the sum over the heads has one order and no atomics.
#include "gemm_sm90.cuh"

extern "C" int flmm_ln_gemm(const void* A, int M, int K, const void* ln_w,
                            const void* ln_b, float eps, const void* row_valid,
                            const void* B, int N, const void* bias, void* out,
                            void* ln_out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int e = gemm::launch_ln_rows((const bf16*)A, M, K, eps, ln_w, ln_b,
                                     row_valid, ln_out, s);
  if (e) return e;
  return gemm::launch_gemm<gemm::NO_ACT, gemm::RESID_NONE, false>(
      ln_out, M, K, B, N, bias, nullptr, out, s);
}

// out (M, N) f32 = resid (M, N) bf16 + A (M, K) @ B (K, N) + bias (N).
extern "C" int flmm_gemm_residual_f32(const void* A, int M, int K,
                                      const void* B, int N, const void* bias,
                                      const void* resid, void* out,
                                      void* stream) {
  return gemm::launch_gemm<gemm::NO_ACT, gemm::RESID_BF16, true>(
      A, M, K, B, N, bias, resid, out, (cudaStream_t)stream);
}

extern "C" const char* flmm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
