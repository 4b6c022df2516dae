// Window attention with the decomposed relative-position bias of SAM's
// ViTDet blocks: one-shot softmax in natural base over the T = side * side
// keys of one 14 x 14 window, the whole window resident in one block.
//
// Replaces eight of the superseded window variants of
// flmm_tpu/ops/sam_flash_experiments.py (K12), one contract
// (q, k, v, rel_pos_h, rel_pos_w, side) -> out over (G, T, 64) window-heads:
//   ::sam_window_attention     (v1, the pallas_call at :695)
//   ::sam_window_attention_v2  (:422)
//   ::sam_window_attention_v3  (:640)
//   ::sam_window_attention_v4  (:545, _window_kernel_v4)
//   ::sam_window_attention_v5  (:545, _window_kernel_v5)
//   ::sam_window_attention_v6  (:185)
//   ::sam_window_attention_v7  (:270)
//   ::sam_window_attention_v8  (:346)
// As functions they differ only in where the operands and the softmax are
// rounded, chosen by the MODE template flag on the lines between the two
// products:
//   SCALE_AFTER  v1 and v6: q unscaled, as it lies in the qkv tensor;
//                s = f32(q . k) * scale + bias_h + bias_w.  (v6 hands its
//                TPU kernel the two bias rows as one row and so adds them to
//                each other first: another order of two f32 additions, far
//                below what the bf16 output resolves.  The plain versions in
//                ops/sam_flash_experiments.py keep each order.)
//   SCALED_Q     v7, v8 and v3: q scaled by `scale` in f32 and rounded to
//                bf16 outside; s = f32(qs . k) + bias_h + bias_w.  (v8 adds
//                the one-hot selection columns to the keys outside its TPU
//                kernel, v7 inside: one function.  v3 takes the bias out of
//                one augmented product [qs | bias_h | bias_w | 1] .
//                [k^T ; sel_h ; sel_w ; pad row], i.e. inside the f32
//                accumulation: another order of f32 additions.  Its pad keys
//                get -1e30 through the ones column, as here.)
//   SCALED_Q_BF16  v4: the SCALED_Q scores (the augmented product of v3
//                with a pad penalty of -1e4), each rounded to bf16; the row
//                max of the rounded scores, p = bf16(exp(bf16(s - max))) as
//                a bf16 subtraction and a bf16 exp give them, and the
//                denominator the f32 sum of the ROUNDED p (the TPU kernel
//                reads it off a ones column of v).  A block holds the whole
//                row, so the max is the TPU body's max.  The -1e4 penalty:
//                the pad keys' rows of v, ones column included, are zero,
//                so they add nothing to the numerator or the denominator
//                whatever their score; they could only move the max if every
//                real score of a row lay below about -1e4.  Masking the keys
//                beyond T to -1e30, as below, is therefore the same function.
//   SCALED_Q_ROUNDED_P  v5: v4's operands, but f32 scores and an f32 exp;
//                p rounded to bf16 before the value product and the
//                denominator the f32 sum of the ROUNDED p (v4's ones column
//                again).  That last part alone sets it apart from v7.  The
//                TPU kernel's software pipelining orders its work only.
//   DENSE_BIAS   v2: q scaled and rounded outside as for SCALED_Q, and the
//                bias not as two thin rows but as the dense tensor the JAX
//                wrapper makes, (G, tp, tp) bf16 with tp = T rounded up to
//                16: bias_h + bias_w summed in f32 and rounded once, -1e30
//                in the pad rows and columns; s = f32(qs . k) + dense.  It
//                is as large as the scores (277 MB at G = 3200 beside 321
//                MB of q, k, v and the output), so it is not staged: each
//                thread reads the two bf16 of its column pair from device
//                memory as it reaches them, once.  The pad columns below tp
//                get their -1e30 from the tensor (the zero-filled pad keys
//                give a score of 0), those from tp to 208 from the kernel.
// In the first three, p = exp(s - max) over the row, taken as
// exp2((s - max) * log2 e) in f32; p is rounded to bf16 for the value
// product and the denominator is the f32 sum of the unrounded p, clamped at
// 1e-30 (v4 and v5: of the rounded p, with expf, so that p lands on the
// bf16 value an f32 exp rounds to).  The TPU kernels pad T to
// a multiple of 16 (v7 / v8 also the operands to 128 lanes), mask the pad
// keys to -1e30, process `group` windows per grid step and expand the thin
// bias rows with one-hot selection products to keep the MXU busy: all of
// that is TPU scheduling and does not carry over.  The bias rows
// [bias_h | bias_w], (G, T, 2 * side) bf16, come from outside as in the JAX
// wrappers and are added to the f32 scores in registers.
//
// What bounds it on an H100: at the kernel bench's shape (G = 3200
// window-heads, T = 196, hd = 64) the two products are 31.5 GFLOP (0.03 ms at
// the bf16 peak) over 321 MB of q, k, v and the output plus 35 MB of bias
// rows (0.11 ms at 3.35 TB/s): bytes bound it, by a factor of three.  So each
// operand should cross the memory bus once.  csrc/relpos_attention.cu (K6,
// window v9) tiles 64 query rows x 64 keys, which at T = 196 restages K and
// V four times per window-head and pads both dimensions to 256 (41% of the
// products wasted).  Here a block owns one window-head: K (196 x 64) and V^T
// are staged once, zero-filled to 208 keys (13 mma depths of 16), and stay in
// shared memory beside the window's bias rows (69 KB a block in all) while
// the block's 4 warps walk its 13 tiles of 16 query rows.  A warp holds one
// tile's whole 16 x 208 score strip in registers (raw mma.sync.m16n8k16,
// whose accumulator layout is known), so max, exp and sum run once over the
// row with no running max and no rescale, and the strip itself is the A
// operand of the value product.  q is read in place with its
// own strides (SCALE_AFTER reads the qkv tensor directly), as are k and v.
// The bias row index of a key (key / side, side + key % side) comes from a
// 416-byte table made once per block, not from a division per score.
// The score strip costs registers: ptxas gives 208 a thread and no spill, so
// two blocks fit an SM where shared memory would admit three.
// Not yet: cp.async / TMA staging overlapped with the first tile, ldmatrix,
// more than one window-head per block (13 tiles over 4 warps leave the fourth
// round one quarter full), the bias rows and the q scaling in-kernel.
//
// Layout: element (g, t, d) of k and v is at
//   (g / nh) * s_b + (g % nh) * s_h + t * s_t + d,
// of q likewise with (q_b, q_h, q_t) and of the output with (o_b, o_h, o_t);
// all strides and base offsets are multiples of 8 elements.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int HD = 64, MAX_T = 208, WARPS = 4, THREADS = WARPS * 32;
constexpr int NT = MAX_T / 8;     // key tiles of 8 in a score strip
constexpr int K_LD = HD + 8;      // Ks[key][d]
constexpr int VT_LD = MAX_T + 8;  // Vt[d][key]
// the order is flmm_tpu_torch.ops.sam_flash_experiments.WINDOW_MODES
enum Mode {
  SCALE_AFTER = 0, SCALED_Q = 1, DENSE_BIAS = 2, SCALED_Q_BF16 = 3,
  SCALED_Q_ROUNDED_P = 4
};
constexpr float LOG2E = 1.4426950408889634f;

// K, V^T, the key table and, but for DENSE_BIAS, the window's bias rows
size_t smem_bytes(int side, int mode) {
  return (size_t)MAX_T * K_LD * 2 + (size_t)HD * VT_LD * 2 +
         (size_t)MAX_T * 2 +
         (mode == DENSE_BIAS ? 0 : (size_t)side * side * 2 * side * 2);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
window_attention_kernel(const bf16* __restrict__ q, long long q_b,
                        long long q_h, long long q_t,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v, long long s_b,
                        long long s_h, long long s_t, int nh,
                        const bf16* __restrict__ bias, int side, int T,
                        float scale, bf16* __restrict__ out, long long o_b,
                        long long o_h, long long o_t) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vt = Ks + MAX_T * K_LD;
  // per key: the columns of its bias_h and bias_w terms in a bias row
  unsigned char* Kidx = reinterpret_cast<unsigned char*>(Vt + HD * VT_LD);
  bf16* Bsm = reinterpret_cast<bf16*>(Kidx + MAX_T * 2);
  const int two_side = 2 * side;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = blockIdx.x;
  const long long q_off = (long long)(g / nh) * q_b + (long long)(g % nh) * q_h;
  const long long in_off = (long long)(g / nh) * s_b + (long long)(g % nh) * s_h;
  const long long out_off = (long long)(g / nh) * o_b + (long long)(g % nh) * o_h;

  // stage the window once: K row-major, V transposed (V^T rows are the B
  // operand of P V), both 0 beyond T; the bias rows; the key table
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int idx = tid; idx < MAX_T * HD / 8; idx += THREADS) {
    const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
    uint4 kv = zero, vv = zero;
    if (r < T) {
      kv = *reinterpret_cast<const uint4*>(k + in_off + r * s_t + c);
      vv = *reinterpret_cast<const uint4*>(v + in_off + r * s_t + c);
    }
    *reinterpret_cast<uint4*>(Ks + r * K_LD + c) = kv;
    const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
    for (int j = 0; j < 8; ++j) Vt[(c + j) * VT_LD + r] = ve[j];
  }
  if constexpr (MODE != DENSE_BIAS) {
    const bf16* bias_g = bias + (long long)g * T * two_side;
    for (int idx = tid; idx < T * two_side; idx += THREADS)
      Bsm[idx] = bias_g[idx];
  }
  // DENSE_BIAS: the side of this window-head's (tp, tp) bias
  [[maybe_unused]] const int tp = (T + 15) / 16 * 16;
  for (int key = tid; key < MAX_T; key += THREADS) {
    Kidx[2 * key] = key < T ? key / side : 0;
    Kidx[2 * key + 1] = key < T ? side + key % side : 0;
  }
  __syncthreads();

  // This thread's two query rows of a tile (fragment rows lane/4 and
  // lane/4 + 8) and its column pair (lane%4)*2.
  const int qr = lane / 4, qc = (lane % 4) * 2;
  for (int r0 = warp * 16; r0 < T; r0 += WARPS * 16) {
    const int t0 = r0 + qr, t1 = t0 + 8;
    uint32_t qf[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int d = kk * 16 + qc;
      const bf16* p0 = q + q_off + t0 * q_t + d;
      const bf16* p1 = q + q_off + t1 * q_t + d;
      qf[kk][0] = t0 < T ? ld32(p0) : 0u;
      qf[kk][1] = t1 < T ? ld32(p1) : 0u;
      qf[kk][2] = t0 < T ? ld32(p0 + 8) : 0u;
      qf[kk][3] = t1 < T ? ld32(p1 + 8) : 0u;
    }

    // the tile's whole score strip: Q (16 x HD) @ K^T (HD x 208)
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* kp = Ks + (nt * 8 + qr) * K_LD + kk * 16 + qc;
        const uint32_t b[2] = {ld32(kp), ld32(kp + 8)};
        mma_16816(s[nt], qf[kk], b);
      }

    // scale (SCALE_AFTER), bias, pad keys to -1e30 as the TPU kernels, row max
    const bf16* brow0 = Bsm + min(t0, T - 1) * two_side;
    const bf16* brow1 = Bsm + min(t1, T - 1) * two_side;
    // DENSE_BIAS: this thread's two rows of the dense bias in device memory
    [[maybe_unused]] const bf16* drow0 =
        bias + ((long long)g * tp + min(t0, T - 1)) * tp;
    [[maybe_unused]] const bf16* drow1 =
        bias + ((long long)g * tp + min(t1, T - 1)) * tp;
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if constexpr (MODE == DENSE_BIAS) {
        // keys nt * 8 + qc and + 1 are one 32-bit word of a row (tp and qc
        // are even); a pad key below tp has a zero score and takes the
        // tensor's -1e30
        const int key = nt * 8 + qc;
        if (key < tp) {
          const float2 b0 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(drow0 + key));
          const float2 b1 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(drow1 + key));
          s[nt][0] += b0.x;
          s[nt][1] += b0.y;
          s[nt][2] += b1.x;
          s[nt][3] += b1.y;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = -1e30f;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mx0 = fmaxf(mx0, s[nt][e]);
          mx1 = fmaxf(mx1, s[nt][2 + e]);
        }
        continue;
      }
      // keys nt * 8 + qc and + 1: (bias_h column, bias_w column) of each
      const uchar4 ki =
          *reinterpret_cast<const uchar4*>(Kidx + 2 * (nt * 8 + qc));
      const int col[2][2] = {{ki.x, ki.y}, {ki.z, ki.w}};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (nt * 8 + qc + e < T) {
          const float bh0 = __bfloat162float(brow0[col[e][0]]);
          const float bw0 = __bfloat162float(brow0[col[e][1]]);
          const float bh1 = __bfloat162float(brow1[col[e][0]]);
          const float bw1 = __bfloat162float(brow1[col[e][1]]);
          if constexpr (MODE == SCALE_AFTER) {
            s[nt][e] = s[nt][e] * scale + bh0 + bw0;
            s[nt][2 + e] = s[nt][2 + e] * scale + bh1 + bw1;
          } else {
            s[nt][e] = s[nt][e] + bh0 + bw0;
            s[nt][2 + e] = s[nt][2 + e] + bh1 + bw1;
          }
        } else {
          s[nt][e] = -1e30f;
          s[nt][2 + e] = -1e30f;
        }
        if constexpr (MODE == SCALED_Q_BF16) {
          s[nt][e] = round_bf16(s[nt][e]);
          s[nt][2 + e] = round_bf16(s[nt][2 + e]);
        }
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);

    // p = exp(s - max) = exp2((s - max) * log2 e); f32 sum of the unrounded p
    // (SCALED_Q_BF16, SCALED_Q_ROUNDED_P: of the p rounded to bf16)
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (MODE == SCALED_Q_BF16) {
          s[nt][e] = round_bf16(expf(round_bf16(s[nt][e] - mx0)));
          s[nt][2 + e] = round_bf16(expf(round_bf16(s[nt][2 + e] - mx1)));
        } else if constexpr (MODE == SCALED_Q_ROUNDED_P) {
          s[nt][e] = round_bf16(expf(s[nt][e] - mx0));
          s[nt][2 + e] = round_bf16(expf(s[nt][2 + e] - mx1));
        } else {
          s[nt][e] = exp2f((s[nt][e] - mx0) * LOG2E);
          s[nt][2 + e] = exp2f((s[nt][2 + e] - mx1) * LOG2E);
        }
        l0 += s[nt][e];
        l1 += s[nt][2 + e];
      }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);

    // O = P (16 x 208 keys) @ V (208 keys x HD); the score accumulators of
    // two adjacent 8-key tiles are exactly one A fragment
    float o[HD / 8][4];
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
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

    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      const int d = dt * 8 + qc;
      if (t0 < T)
        *reinterpret_cast<uint32_t*>(out + out_off + t0 * o_t + d) =
            pack2(o[dt][0] * inv0, o[dt][1] * inv0);
      if (t1 < T)
        *reinterpret_cast<uint32_t*>(out + out_off + t1 * o_t + d) =
            pack2(o[dt][2] * inv1, o[dt][3] * inv1);
    }
  }
}

template <int MODE>
int launch(const bf16* q, long long q_b, long long q_h, long long q_t,
           const bf16* k, const bf16* v, long long s_b, long long s_h,
           long long s_t, int nh, const bf16* bias, int side, int G, int T,
           float scale, bf16* out, long long o_b, long long o_h,
           long long o_t, cudaStream_t stream) {
  const size_t smem = smem_bytes(side, MODE);
  const cudaError_t e = cudaFuncSetAttribute(
      window_attention_kernel<MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  window_attention_kernel<MODE><<<G, THREADS, smem, stream>>>(
      q, q_b, q_h, q_t, k, v, s_b, s_h, s_t, nh, bias, side, T, scale, out,
      o_b, o_h, o_t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flmm_window_attention(const void* q, long long q_b,
                                     long long q_h, long long q_t,
                                     const void* k, const void* v,
                                     long long s_b, long long s_h,
                                     long long s_t, int nh, const void* bias,
                                     int side, int G, int T, int head_dim,
                                     int mode, float scale, void* out,
                                     long long o_b, long long o_h,
                                     long long o_t, void* stream) {
  if (head_dim != HD || G <= 0 || T <= 0 || T > MAX_T || nh <= 0 ||
      side <= 0 || side * side != T || mode < SCALE_AFTER ||
      mode > SCALED_Q_ROUNDED_P ||
      q_b % 8 || q_h % 8 || q_t % 8 || s_b % 8 || s_h % 8 || s_t % 8 ||
      o_b % 2 || o_h % 2 || o_t % 2)
    return (int)cudaErrorInvalidValue;
#define FLMM_LAUNCH(MODE)                                                   \
  launch<MODE>((const bf16*)q, q_b, q_h, q_t, (const bf16*)k,               \
               (const bf16*)v, s_b, s_h, s_t, nh, (const bf16*)bias, side,  \
               G, T, scale, (bf16*)out, o_b, o_h, o_t, (cudaStream_t)stream)
  switch (mode) {
    case SCALE_AFTER: return FLMM_LAUNCH(SCALE_AFTER);
    case SCALED_Q: return FLMM_LAUNCH(SCALED_Q);
    case DENSE_BIAS: return FLMM_LAUNCH(DENSE_BIAS);
    case SCALED_Q_BF16: return FLMM_LAUNCH(SCALED_Q_BF16);
    default: return FLMM_LAUNCH(SCALED_Q_ROUNDED_P);
  }
#undef FLMM_LAUNCH
}
