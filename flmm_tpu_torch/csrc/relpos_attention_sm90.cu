// Non-causal attention with the decomposed relative-position bias of SAM's
// ViTDet blocks on Hopper's wgmma + TMA machinery, under one of five softmax
// modes (the order is flmm_tpu_torch.ops.sam_flash.SOFTMAX_*):
//
//   score(i, j) = alpha (q_i . k_j) + bias_h[i, j / side] + bias_w[i, j % side]
//
//   SOFTMAX_LOG2         p = exp2(score - max) with log2-domain bias:
//                        flmm_tpu/ops/sam_flash.py::sam_global_attention_v8
//                        (K2, the pallas_call at :292) and every caller of
//                        its function: the 16-head 14x14 window attention
//                        inside flmm_tpu/ops/window_block.py::window_block
//                        (K1), ::sam_window_attention_v9 (K6, :122), the
//                        attention of flmm_tpu/ops/global_block.py::
//                        global_attn_block (K10) and flmm_tpu/ops/
//                        sam_flash_experiments.py::sam_global_attention_v7
//                        (:981);
//   SOFTMAX_NATURAL      global v3 (::sam_global_attention_v3, :1046), v6
//                        (:942) and v2 (:781): the bias rows in natural base
//                        rounded to bf16 (v3 and v6 round them to q's dtype,
//                        v2 to bf16: one function on the card) and p =
//                        exp(score - max).  Staged as bf16(bias) * log2(e)
//                        with alpha = scale * log2(e), so the key loop is
//                        K2's: the same function up to f32 rounding;
//   SOFTMAX_NATURAL_SCALE_AFTER
//                        global v1 (::sam_global_attention, :1107): as
//                        SOFTMAX_NATURAL, the score summed in the JAX order
//                        (alpha (q . k) + bias_h) + bias_w;
//   SOFTMAX_NATURAL_BF16 global v4 (:859): SOFTMAX_NATURAL's operands in
//                        natural base (alpha = scale), every score rounded
//                        to bf16, the max taken over the rounded scores, p =
//                        bf16(exp(bf16(score - max))) in bf16x2 pairs and the
//                        denominator the f32 sum of the ROUNDED p, taken as
//                        the TPU kernel takes it: P times a ones column, on
//                        the tensor cores (mma.sync).  The TPU
//                        body sees the whole row; here the max runs over key
//                        tiles, so a p computed against an earlier max is
//                        rounded at other values before the f32 rescale
//                        brings it to the final max: a difference inside the
//                        variant's own 0.4% softmax rounding;
//   SOFTMAX_LOG2_NO_MAX  global v11 (:1309): the bias rows in the log2
//                        domain rounded to bf16 and p = exp2(score) with no
//                        running max and no rescale: plain sums, a masked
//                        key adds exp2(-inf) = 0.  A score of 128 or more
//                        overflows to a non-finite row, as on the TPU: the
//                        caller's precondition.
//
// At head_dim 64 the JAX wrappers' bf16(q * scale) is q * 2^-3 exactly, so
// scale on the f32 scores of the unscaled q is their function; v11's wrapper
// rounds q * scale * log2(e), which alpha = scale * log2(e) on the scores
// replaces (one bf16 rounding of q apart).  The variants replace the first
// port's csrc/relpos_attention.cu (mma.sync, synchronous K / V^T staging,
// bias rows and a scaled copy of q made by plain PyTorch in front of each
// launch: 67 MB and 33.5 MB at G = 64, S = 4096).
//
// What bounds it on an H100: at K2's shape (G = 64 image-heads, S = 4096,
// hd = 64) the two products are 275 GFLOP (0.278 ms at the bf16 peak) and
// each of the 1.07 G scores needs one exp2 on the SFUs (16 a clock an SM,
// ~0.3 ms), so tensor cores and SFUs bound it together; the (G, S, S)
// scores never reach device memory.  The design:
//
// - a block owns 64 query rows of one (image, head) per consumer warpgroup
//   (3 at side 64, 192 rows, one block an SM; 2 elsewhere, 128 rows, two
//   blocks an SM) and one producer warp.  The producer keeps TMA loads of
//   64-key K and V tiles (128-byte swizzle) in flight through a ring of
//   STAGES shared-memory stages with full / empty mbarriers;
// - S = Q K^T is wgmma m64n64k16 with Q and K straight from the swizzled
//   tiles; the online softmax runs in base 2 on the f32 accumulators; the
//   probabilities, rounded to bf16, are the A operand of O += P V straight
//   from registers, and V is read through wgmma's transposed-B (MN-major)
//   descriptor -- no transpose of V anywhere.  The warpgroups interleave:
//   one's softmax runs beside another's products.  (Issuing S(t + 1)
//   before P(t) V(t) inside a warpgroup was slower in a trial build: more
//   registers and waits for no overlap the other warpgroups did not give.)
// - the bias rows reach shared memory (f32, 2 side a row, padded to an odd
//   stride against bank conflicts) in one of two ways.  From tables (K2,
//   K6, every global variant): the block's two (2 side - 1, 64)
//   rel-pos tables come in by TMA beside Q, each warpgroup forms Q T^T with
//   one more wgmma (2 x 64 x 128 x 64 at side 64, ~6% of the key loop's
//   products) and scatters column m of row i to key row or column
//   y_i - m + side - 1 (x_i for the width table), as the mode stages it
//   (times log2(e), or rounded to bf16 first); q is read unscaled and alpha
//   goes onto the f32 scores, so the wrapper runs no pass over q.  From rows
//   (K1, K10; SOFTMAX_LOG2 only): the (G, S, 2 side) log2-domain rows the
//   JAX layout carries, with q pre-scaled (alpha = 1);
// - where a key tile is one grid row (side 64), each thread keeps the width
//   bias of its 16 key columns in registers and reads one height bias a row
//   and tile; elsewhere (any other side, 1 and up) it reads both per score,
//   walking the keys' grid rows and columns without a division: 8 / side
//   rows and 8 % side columns per 8 key columns, 64 / side and 64 % side
//   per key tile, one carry each;
// - every grid side from 1 to 147.  Tables of up to 128 rows (side <= 64)
//   are one wgmma of N = 32, 64 or 128; longer ones (SAM above 1024: side
//   80 at 1280, 128 at 2048) come in as chunks of 128 rows, one product and
//   one scatter each, column m of chunk c being table row 128 c + m (the
//   variants take chunks of 64 rows at every side but 64: three
//   instantiations a mode).  The
//   f32 bias rows grow with the side (64 x (2 side + 1) x 4 bytes a
//   consumer warpgroup, 66 KB at side 128), so where two consumer
//   warpgroups no longer fit the 227 KB of shared memory a block has, the
//   launcher takes one (64 query rows a block); side 147 is the widest
//   grid whose one-warpgroup block fits, and a wider one is refused.
//
// Layouts: element (g, t, d) of q is at (g / nh) q_b + (g % nh) q_h + t q_t
// + d, of k and v likewise with (s_b, s_h, s_t), of out with (o_b, o_h,
// o_t).  Each of q, k and v is read through a 2D tensor map over its rows
// (pitch q_t or s_t, 64-row boxes at column (g % nh) q_h and row (g / nh)
// q_b / q_t + t), so contiguous (G, S, 64) heads (K2) and (NW, nh, T, 64)
// views of a (NW T, 3C) qkv tensor (K1, K6, K10) are read in place.  A key
// tile that runs past S reads the next window's rows (or TMA's zeros past
// the tensor): those keys are masked by index, never by value.  Query rows
// past S are computed and not stored.  Pad tokens inside S are not masked
// (K1 gives them k = b_k, v = b_v, as the reference does).
#include "sm90.cuh"

namespace {

constexpr int HD = 64, BKV = 64, STAGES = 3, MAX_SIDE = 147;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block can have
constexpr int TILE_BYTES = 64 * HD * 2;        // one 64-row box
constexpr int STAGE_BYTES = 2 * TILE_BYTES;    // K and V
constexpr float LOG2E = 1.4426950408889634f;
// the order is flmm_tpu_torch.ops.sam_flash.SOFTMAX_*
enum Softmax {
  SOFTMAX_LOG2 = 0, SOFTMAX_NATURAL = 1, SOFTMAX_LOG2_NO_MAX = 2,
  SOFTMAX_NATURAL_SCALE_AFTER = 3, SOFTMAX_NATURAL_BF16 = 4
};

// What the table product x of a query and a table row becomes in the bias
// rows: the JAX wrappers' rounding of the bias, in the domain of the scores.
template <int MODE>
__device__ __forceinline__ float staged_bias(float x) {
  if constexpr (MODE == SOFTMAX_LOG2) return x * LOG2E;
  else if constexpr (MODE == SOFTMAX_LOG2_NO_MAX) return round_bf16(x * LOG2E);
  else if constexpr (MODE == SOFTMAX_NATURAL_BF16) return round_bf16(x);
  else return round_bf16(x) * LOG2E;
}

// The score of accumulator s with this key's two bias entries (v4's is
// rounded to bf16 where p is formed).
template <int MODE>
__device__ __forceinline__ float biased(float s, float alpha, float bh,
                                        float bw) {
  if constexpr (MODE == SOFTMAX_NATURAL_SCALE_AFTER)
    return fmaf(s, alpha, bh) + bw;
  else
    return fmaf(s, alpha, bh + bw);
}

// Byte offsets into the 1024-aligned dynamic shared memory.
struct Layout {
  int stages, tables, bias, bars, total;
};

// cons consumer warpgroups of 64 query rows each; nt rows of each table
// resident (0: bias rows from device memory)
__host__ __device__ inline Layout layout(int side, int nt, int cons) {
  Layout l;
  l.stages = cons * TILE_BYTES;
  l.tables = l.stages + STAGES * STAGE_BYTES;
  l.bias = l.tables + 2 * nt * 128;
  l.bars = l.bias + 64 * cons * (2 * side + 1) * 4;
  l.total = l.bars + (2 * STAGES + 1) * 8;
  return l;
}

// MODE: a SOFTMAX_* code; TABLES: bias rows from the two rel-pos tables
// (chunks of NT rows), else from `bias`; ROW_TILE: side == BKV, a key tile
// is one grid row.
template <int MODE, bool TABLES, bool ROW_TILE, int NT, int CONS>
__global__ void __launch_bounds__(CONS * 128 + 32,
                                  ROW_TILE || NT == 128 ? 1 : 2)
relpos_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_th,
                   const __grid_constant__ CUtensorMap map_tw, int nh,
                   int q_row_step, int q_col_step, int kv_row_step,
                   int kv_col_step, const bf16* __restrict__ bias, int side,
                   int S, float alpha, bf16* __restrict__ out, long long o_b,
                   long long o_h, long long o_t) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  // table chunks of NT rows: one but for tables longer than NT rows
  const int chunks = TABLES ? (2 * side - 1 + NT - 1) / NT : 0;
  const int table_bytes = chunks * NT * 128;
  const Layout L = layout(side, chunks * NT, CONS);
  float* Bsm = reinterpret_cast<float*>(smem + L.bias);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;
  const int tid = threadIdx.x, wg = tid / 128;
  const int g = blockIdx.y, q0 = blockIdx.x * 64 * CONS;
  const int img = g / nh, head = g % nh;
  const int KT = (S + BKV - 1) / BKV;
  const int two_side = 2 * side, bld = two_side + 1;  // odd: no bank
                                                       // conflicts

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONS * 4);  // one arrival a warp
    }
    sm90::mbar_init(qbar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONS) {
    // producer warp: one thread loads Q (and the tables), then keeps the
    // K / V ring full
    if (tid == CONS * 128) {
      const int qr = img * q_row_step + q0, qc = head * q_col_step;
      sm90::mbar_expect_tx(qbar, CONS * TILE_BYTES + 2 * table_bytes);
      for (int c = 0; c < CONS; ++c)
        sm90::tma_load_2d(smem + c * TILE_BYTES, &map_q, qbar, qc,
                          qr + 64 * c);
      for (int c = 0; c < chunks; ++c) {
        sm90::tma_load_2d(smem + L.tables + c * NT * 128, &map_th, qbar, 0,
                          c * NT);
        sm90::tma_load_2d(smem + L.tables + table_bytes + c * NT * 128,
                          &map_tw, qbar, 0, c * NT);
      }
      const int kr = img * kv_row_step, kc = head * kv_col_step;
      for (int t = 0; t < KT; ++t) {
        const int s = t % STAGES;
        sm90::mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        unsigned char* st = smem + L.stages + s * STAGE_BYTES;
        sm90::mbar_expect_tx(&full[s], STAGE_BYTES);
        sm90::tma_load_2d(st, &map_k, &full[s], kc, kr + t * BKV);
        sm90::tma_load_2d(st + TILE_BYTES, &map_v, &full[s], kc,
                          kr + t * BKV);
      }
    }
    return;
  }

  // This thread's two rows (accumulator rows lane / 4 and lane / 4 + 8 of
  // its warp's 16) and its column pair (lane % 4) * 2 of every 8.
  const int warp = (tid % 128) / 32, lane = tid % 32, c2 = (lane % 4) * 2;
  const int row0 = wg * 64 + warp * 16 + lane / 4, row1 = row0 + 8;
  const int t0 = q0 + row0, t1 = q0 + row1;
  float* B0 = Bsm + row0 * bld;
  float* B1 = Bsm + row1 * bld;
  const unsigned char* Qw = smem + wg * TILE_BYTES;

  if constexpr (!TABLES) {
    // this warpgroup's 64 bias rows, zeros past S
    for (int idx = tid % 128; idx < 64 * two_side; idx += 128) {
      const int r = wg * 64 + idx / two_side, t = q0 + r;
      Bsm[r * bld + idx % two_side] =
          t < S ? __bfloat162float(
                      bias[((long long)g * S + t) * two_side + idx % two_side])
                : 0.f;
    }
    sm90::mbar_wait(qbar, 0);
  } else {
    sm90::mbar_wait(qbar, 0);
    float acc[NT / 2];
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int tab = 0; tab < 2; ++tab)
      for (int c = 0; c < chunks; ++c) {
        sm90::table_product<NT>(
            acc, Qw, smem + L.tables + tab * table_bytes + c * NT * 128);
        // column m of row t (table row c NT + m): key row (tab 0) or
        // column (tab 1) y - c NT - m + side - 1, y the query's grid row
        // or column
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = h ? t1 : t0;
          float* dst = (h ? B1 : B0) + tab * side;
          if (t >= S) {
            if (c == 0)
              for (int kk = 0; kk < side; ++kk) dst[kk] = 0.f;
            continue;
          }
          const int y = (tab == 0 ? t / side : t % side) + side - 1 - c * NT;
#pragma unroll
          for (int j = 0; j < NT / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kk = y - (8 * j + c2 + e);
              if (kk >= 0 && kk < side)
                dst[kk] = staged_bias<MODE>(acc[4 * j + 2 * h + e]);
            }
        }
      }
  }
  sm90::named_sync(1 + wg, 128);

  // side 64: the width bias of this thread's 16 key columns, every tile
  float bw0[ROW_TILE ? BKV / 4 : 1], bw1[ROW_TILE ? BKV / 4 : 1];
  if constexpr (ROW_TILE) {
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        bw0[2 * j + e] = B0[BKV + 8 * j + c2 + e];
        bw1[2 * j + e] = B1[BKV + 8 * j + c2 + e];
      }
  }

  // elsewhere: the grid row and column of this thread's first key column
  // (kv0 + c2), carried from tile to tile without a division; any side
  const int step_h = BKV / side, step_w = BKV % side;
  const int step8_h = 8 / side, step8_w = 8 % side;
  int kh_t = c2 / side, kw_t = c2 % side;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  // S(t) = Q K(t)^T, 64 x 64 keys: issued, not waited for
  auto issue_qk = [&](int t, float* sc) {
    const unsigned char* Ks = smem + L.stages + (t % STAGES) * STAGE_BYTES;
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      sm90::wgmma_ss_n64<0>(sc, sm90::desc_kmajor(Qw + kk * 32),
                            sm90::desc_kmajor(Ks + kk * 32), kk > 0);
    sm90::wgmma_commit();
  };

  // p, rounded to bf16: the score accumulators of 16 keys are one A
  // fragment of P V (pair j of a row is pa[j / 2][2 (j % 2) + row])
  uint32_t pa[BKV / 16][4];
  // v4: the row sums of its rows, whole (elements 0 and 2 of an m16n8
  // accumulator; 1 and 3 repeat them)
  float lsum[4] = {0.f, 0.f, 0.f, 0.f};

  // alpha * s + bias, keys past S masked, then the mode's softmax in place:
  // sc becomes p (v4: pa holds it); r0 / r1 rescale what came before
  auto softmax = [&](int t, float* sc, float& r0, float& r1) {
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
    if constexpr (ROW_TILE) {
      const float bh0 = B0[t], bh1 = B1[t];
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& a = sc[4 * j + e];
          float& b = sc[4 * j + 2 + e];
          a = biased<MODE>(a, alpha, bh0, bw0[2 * j + e]);
          b = biased<MODE>(b, alpha, bh1, bw1[2 * j + e]);
          mx0 = fmaxf(mx0, a);
          mx1 = fmaxf(mx1, b);
        }
    } else {
      int kh = kh_t, kw = kw_t;  // key column 8 j + c2 of the tile
      const int key0 = t * BKV + c2;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        const bool wrap = kw + 1 == side;  // key column 8 j + c2 + 1
        const int kh1 = wrap ? kh + 1 : kh, kw1 = wrap ? 0 : kw + 1;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& a = sc[4 * j + e];
          float& b = sc[4 * j + 2 + e];
          const int h = e ? kh1 : kh, w = side + (e ? kw1 : kw);
          if (key0 + 8 * j + e < S) {
            a = biased<MODE>(a, alpha, B0[h], B0[w]);
            b = biased<MODE>(b, alpha, B1[h], B1[w]);
          } else {
            a = -CUDART_INF_F;
            b = -CUDART_INF_F;
          }
          mx0 = fmaxf(mx0, a);
          mx1 = fmaxf(mx1, b);
        }
        kw += step8_w;
        kh += step8_h;
        if (kw >= side) {
          kw -= side;
          ++kh;
        }
      }
      kw_t += step_w;
      kh_t += step_h;
      if (kw_t >= side) {
        kw_t -= side;
        ++kh_t;
      }
    }
    float ps0 = 0.f, ps1 = 0.f;
    if constexpr (MODE == SOFTMAX_LOG2_NO_MAX) {
      // plain sums: nothing to rescale
      r0 = r1 = 1.f;
#pragma unroll
      for (int i = 0; i < BKV / 4; ++i) {
        sc[2 * i] = sm90::ex2(sc[2 * i]);
        sc[2 * i + 1] = sm90::ex2(sc[2 * i + 1]);
        (i % 2 ? ps1 : ps0) += sc[2 * i] + sc[2 * i + 1];
      }
      l0 += ps0;
      l1 += ps1;
      return;
    } else if constexpr (MODE == SOFTMAX_NATURAL_BF16) {
      // the max of the rounded scores is the rounded max (rounding is
      // monotone); s and s - max rounded in bf16x2 pairs, exp(d) = exp2(d
      // log2 e) in f32 rounded to bf16: p is the A fragment as it is
      const float mn0 = fmaxf(m0, round_bf16(quad_max(mx0)));
      const float mn1 = fmaxf(m1, round_bf16(quad_max(mx1)));
      r0 = sm90::ex2((m0 - mn0) * LOG2E);
      r1 = sm90::ex2((m1 - mn1) * LOG2E);
      m0 = mn0;
      m1 = mn1;
      const __nv_bfloat162 mb0 = __float2bfloat162_rn(mn0);
      const __nv_bfloat162 mb1 = __float2bfloat162_rn(mn1);
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 d = __bfloat1622float2(__hsub2(
              __floats2bfloat162_rn(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]),
              r ? mb1 : mb0));
          const __nv_bfloat162 pp = __floats2bfloat162_rn(
              sm90::ex2(d.x * LOG2E), sm90::ex2(d.y * LOG2E));
          pa[j / 2][2 * (j % 2) + r] = *reinterpret_cast<const uint32_t*>(&pp);
        }
      // the row sums of the rounded p, as the TPU kernel takes them: P
      // times a ones column on the tensor cores (mma.sync m16n8k16, its A
      // fragments the same registers as P V's), accumulated in f32
      const uint32_t ones[2] = {0x3F803F80u, 0x3F803F80u};
      lsum[0] *= r0;
      lsum[1] *= r0;
      lsum[2] *= r1;
      lsum[3] *= r1;
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) mma_16816(lsum, pa[kk], ones);
      return;
    } else {
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      r0 = sm90::ex2(m0 - mn0);
      r1 = sm90::ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * j + e] = sm90::ex2(sc[4 * j + e] - mn0);
          sc[4 * j + 2 + e] = sm90::ex2(sc[4 * j + 2 + e] - mn1);
          ps0 += sc[4 * j + e];
          ps1 += sc[4 * j + 2 + e];
        }
    }
    l0 = l0 * r0 + ps0;  // this thread's columns; summed over the quad at
    l1 = l1 * r1 + ps1;  // the end
  };

  auto pack_p = [&](const float* sc) {
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      pa[kk][0] = pack2(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack2(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack2(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack2(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };

  // per key tile: S = Q K^T, the softmax, O += P V; the two warpgroups
  // interleave, one's softmax beside the other's products
  float sc[BKV / 2], r0, r1;
  for (int t = 0; t < KT; ++t) {
    sm90::mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
    issue_qk(t, sc);
    sm90::wgmma_wait<0>();
    sm90::fence_regs<BKV / 2>(sc);
    softmax(t, sc, r0, r1);
    if constexpr (MODE != SOFTMAX_LOG2_NO_MAX) {
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        o[4 * dt] *= r0;
        o[4 * dt + 1] *= r0;
        o[4 * dt + 2] *= r1;
        o[4 * dt + 3] *= r1;
      }
    }
    if constexpr (MODE != SOFTMAX_NATURAL_BF16) pack_p(sc);
    const unsigned char* Vs =
        smem + L.stages + (t % STAGES) * STAGE_BYTES + TILE_BYTES;
    sm90::fence_regs<HD / 2>(o);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      sm90::wgmma_rs_n64<1>(o, pa[kk],
                            sm90::desc_mnmajor(Vs + kk * 2048, TILE_BYTES), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs<HD / 2>(o);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[t % STAGES]);
  }

  if constexpr (MODE == SOFTMAX_NATURAL_BF16) {
    l0 = lsum[0];
    l1 = lsum[2];
  } else {
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* ob = out + (long long)img * o_b + (long long)head * o_h;
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    const int d = dt * 8 + c2;
    if (t0 < S)
      *reinterpret_cast<uint32_t*>(ob + t0 * o_t + d) =
          pack2(o[4 * dt] * inv0, o[4 * dt + 1] * inv0);
    if (t1 < S)
      *reinterpret_cast<uint32_t*>(ob + t1 * o_t + d) =
          pack2(o[4 * dt + 2] * inv1, o[4 * dt + 3] * inv1);
  }
}

// Side 64 (a key tile is one grid row): 3 consumer warpgroups, 192 query
// rows a block, one block an SM (200 KB of shared memory); elsewhere 2 of
// them and two blocks an SM, whose prologues and short key loops (4 tiles
// at T = 196) overlap, or 1 where the bias rows of 2 do not fit.
size_t smem_bytes(int side, int nt, int cons) {
  return layout(side, nt, cons).total + 1024;  // + the 1024 alignment
}

template <int MODE, bool TABLES, bool ROW_TILE, int NT, int CONS>
int launch(const CUtensorMap* maps, int nh, long long q_b, long long q_h,
           long long q_t, long long s_b, long long s_h, long long s_t,
           const bf16* bias, int side, int G, int S, float alpha, bf16* out,
           long long o_b, long long o_h, long long o_t, cudaStream_t stream) {
  auto kernel = relpos_sm90_kernel<MODE, TABLES, ROW_TILE, NT, CONS>;
  const int nt = TABLES ? (2 * side - 1 + NT - 1) / NT * NT : 0;
  const size_t smem = smem_bytes(side, nt, CONS);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + 64 * CONS - 1) / (64 * CONS), G);
  kernel<<<grid, CONS * 128 + 32, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], nh, (int)(q_b / q_t),
      (int)q_h, (int)(s_b / s_t), (int)s_h, bias, side, S, alpha, out, o_b,
      o_h, o_t);
  return (int)cudaGetLastError();
}

// The rows of table each chunk holds: K2's instantiations 32, 64 or 128
// (one chunk up to side 64); the variants' 128 at side 64 and 64 elsewhere.
int table_chunk(int mode, int side) {
  const int n = 2 * side - 1;
  if (side == BKV) return 128;
  if (mode != SOFTMAX_LOG2) return 64;
  return n <= 32 ? 32 : n <= 64 ? 64 : 128;
}

}  // namespace

// bias (G, S, 2 side) log2-domain rows (mode SOFTMAX_LOG2 only), or else
// table_h and table_w, the (2 side - 1, 64) rel-pos tables in natural base;
// 1 <= side <= 147; mode a SOFTMAX_* code; alpha the factor of q . k.
extern "C" int flmm_relpos_attention_sm90(
    const void* q, long long q_b, long long q_h, long long q_t, const void* k,
    const void* v, long long s_b, long long s_h, long long s_t, int nh,
    const void* bias, const void* table_h, const void* table_w, int side,
    int G, int S, int mode, float alpha, void* out, long long o_b,
    long long o_h, long long o_t, void* stream) {
  const bool tables = table_h != nullptr;
  if (G <= 0 || G > 65535 || nh <= 0 || G % nh || side < 1 ||
      side > MAX_SIDE || side * side != S || mode < SOFTMAX_LOG2 ||
      mode > SOFTMAX_NATURAL_BF16 ||
      (tables ? table_w == nullptr : bias == nullptr || mode != SOFTMAX_LOG2) ||
      o_b % 2 || o_h % 2 || o_t % 2)
    return (int)cudaErrorInvalidValue;
  if (nh == 1) q_h = s_h = 0;
  CUtensorMap maps[5] = {};
  int e = make_head_map(&maps[0], q, q_b, q_h, q_t, nh, G, S, 64);
  if (!e) e = make_head_map(&maps[1], k, s_b, s_h, s_t, nh, G, S, 64);
  if (!e) e = make_head_map(&maps[2], v, s_b, s_h, s_t, nh, G, S, 64);
  // the table rows in boxes of one chunk
  const int n = 2 * side - 1, nt = table_chunk(mode, side);
  if (!e && tables) e = make_tile_map(&maps[3], table_h, HD, n, HD, nt);
  if (!e && tables) e = make_tile_map(&maps[4], table_w, HD, n, HD, nt);
  if (e) return e;
  const cudaStream_t st = (cudaStream_t)stream;
  // two consumer warpgroups where their bias rows fit, else one
  const bool two =
      smem_bytes(side, tables ? (n + nt - 1) / nt * nt : 0, 2) <= SMEM_LIMIT;
#define FLMM_LAUNCH(MODE, TABLES, ROW_TILE, NT, CONS)                       \
  launch<MODE, TABLES, ROW_TILE, NT, CONS>(                                 \
      maps, nh, q_b, q_h, q_t, s_b, s_h, s_t, (const bf16*)bias, side, G, S, \
      alpha, (bf16*)out, o_b, o_h, o_t, st)
#define FLMM_VARIANT(MODE)                                                 \
  return side == BKV ? FLMM_LAUNCH(MODE, true, true, 128, 3)               \
         : two       ? FLMM_LAUNCH(MODE, true, false, 64, 2)               \
                     : FLMM_LAUNCH(MODE, true, false, 64, 1)
  if (!tables) {
    if (side == BKV) return FLMM_LAUNCH(SOFTMAX_LOG2, false, true, 0, 3);
    return two ? FLMM_LAUNCH(SOFTMAX_LOG2, false, false, 0, 2)
               : FLMM_LAUNCH(SOFTMAX_LOG2, false, false, 0, 1);
  }
  switch (mode) {
    case SOFTMAX_NATURAL: FLMM_VARIANT(SOFTMAX_NATURAL);
    case SOFTMAX_NATURAL_SCALE_AFTER:
      FLMM_VARIANT(SOFTMAX_NATURAL_SCALE_AFTER);
    case SOFTMAX_NATURAL_BF16: FLMM_VARIANT(SOFTMAX_NATURAL_BF16);
    case SOFTMAX_LOG2_NO_MAX: FLMM_VARIANT(SOFTMAX_LOG2_NO_MAX);
    default: break;
  }
  if (side == BKV) return FLMM_LAUNCH(SOFTMAX_LOG2, true, true, 128, 3);
  if (nt == 32) return FLMM_LAUNCH(SOFTMAX_LOG2, true, false, 32, 2);
  if (nt == 64) return FLMM_LAUNCH(SOFTMAX_LOG2, true, false, 64, 2);
  return two ? FLMM_LAUNCH(SOFTMAX_LOG2, true, false, 128, 2)
             : FLMM_LAUNCH(SOFTMAX_LOG2, true, false, 128, 1);
#undef FLMM_VARIANT
#undef FLMM_LAUNCH
}
