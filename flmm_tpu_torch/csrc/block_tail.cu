// Transformer block tail: x = s + a @ wo + bo;  out = x + W2 act(W1 LN(x) + b1) + b2.
//
// Replaces flmm_tpu/ops/fused_block.py::fused_proj_ln_mlp (K4, the
// pallas_call at :154) and serves the out-proj + LN2 + MLP stage of
// flmm_tpu/ops/window_block.py::window_block (K1).
//
// What bounds it on an H100: per row it does 2 (C^2 + 2 C F) FLOP (18.9
// MFLOP at C = 1024, F = 4096) against two bf16 input rows and one output
// row, so the tensor cores bound it: 310 GFLOP, 0.313 ms at 16,384 rows.
// Four launches, three of them on the wgmma + TMA GEMM core of
// csrc/gemm_sm90.cuh:
//
//   1. x = s + a @ wo + bo, in f32 (N, C);
//   2. the LayerNorm row pass: LN(x) in bf16;
//   3. h = act(LN(x) @ W1 + b1), rounded to bf16 (N, F) -- the rounding
//      point of the TPU kernel (fused_block.py:109);
//   4. out = x + h @ W2 + b2, rounded once to bf16.
//
// The TPU kernel carried the F reduction across a sequential grid axis with
// the (N, F) hidden in VMEM.  On Hopper no SM holds a 128-row LN(x) tile
// (256 KB at C = 1024) beside a 128 x C f32 output accumulator, and the
// kernel this one replaces, which kept 32 whole rows a block and looped
// over F, streamed all 18 MB of weights from L2 for every 32 rows (9.4 GB
// at 16,384 rows).  Here each product runs at the GEMM core's rate and the
// hidden makes one bf16 round trip, 2 x 134 MB at 16,384 rows (~0.08 ms at
// the memory rate), plus 2 x 67 MB of f32 x: a tenth of the time the
// products take, for one core that serves seven call sites.  A fused tail
// split over a cluster's shared memory is the next option if a profile
// asks for it.
//
// The same without step 1 (x is the bf16 input rows, and the residual of
// step 4 reads them) is the LN2 + MLP + residual of
// flmm_tpu/ops/fused_block.py::fused_ln_mlp (K8, the pallas_call at :264),
// entry point flmm_ln_mlp.  Every C and F that are multiples of 128.
#include "gemm_sm90.cuh"

namespace {

bool widths_ok(int N, int C, int F) {
  return N > 0 && C > 0 && F > 0 && C % 128 == 0 && F % 128 == 0;
}

}  // namespace

// x_f32 (N, C), ln (N, C) bf16 and h (N, F) bf16 are the caller's scratch.
extern "C" int flmm_block_tail(const void* shortcut, const void* attn, int N,
                               int C, int F, const void* wo, const void* bo,
                               const void* ln_w, const void* ln_b, float eps,
                               const void* w1, const void* b1, const void* w2,
                               const void* b2, int act, void* out, void* x_f32,
                               void* ln, void* h, void* stream) {
  if (!widths_ok(N, C, F)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int e = gemm::launch_gemm<gemm::NO_ACT, gemm::RESID_BF16, true>(
      attn, N, C, wo, C, bo, shortcut, x_f32, s);
  if (e) return e;
  e = gemm::launch_ln_rows((const float*)x_f32, N, C, eps, ln_w, ln_b,
                           nullptr, ln, s);
  if (e) return e;
  e = gemm::launch_gemm_act(act, ln, N, C, w1, F, b1, h, s);
  if (e) return e;
  return gemm::launch_gemm<gemm::NO_ACT, gemm::RESID_F32, false>(
      h, N, F, w2, C, b2, x_f32, out, s);
}

// K8: out = x + W2 act(W1 LN(x) + b1) + b2 over (N, C) rows; ln (N, C) and
// h (N, F) bf16 are the caller's scratch.
extern "C" int flmm_ln_mlp(const void* x, int N, int C, int F,
                           const void* ln_w, const void* ln_b, float eps,
                           const void* w1, const void* b1, const void* w2,
                           const void* b2, int act, void* out, void* ln,
                           void* h, void* stream) {
  if (!widths_ok(N, C, F)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int e = gemm::launch_ln_rows((const bf16*)x, N, C, eps, ln_w, ln_b,
                               nullptr, ln, s);
  if (e) return e;
  e = gemm::launch_gemm_act(act, ln, N, C, w1, F, b1, h, s);
  if (e) return e;
  return gemm::launch_gemm<gemm::NO_ACT, gemm::RESID_BF16, false>(
      h, N, F, w2, C, b2, x, out, s);
}
