// Window attention with the decomposed relative-position bias of SAM's
// ViTDet blocks on Hopper's wgmma + TMA machinery: one-shot softmax over the
// T = side * side keys of a window (side <= 14), one window-head at a time.
//
// Replaces the K12 window variants of flmm_tpu/ops/sam_flash_experiments.py,
// each a MODE of one kernel:
//   SCALE_AFTER, SCALED_Q   ::sam_window_attention (v1, the pallas_call at
//                           :695), ::_v6 (:185); ::_v7 (:270), ::_v8 (:346),
//                           ::_v3 (:640)
//   DENSE_BIAS              ::sam_window_attention_v2 (:422)
//   SCALED_Q_BF16           ::sam_window_attention_v4 (:545, body :437)
//   SCALED_Q_ROUNDED_P      ::sam_window_attention_v5 (:545, body :462)
//   SPATIAL_LOG2            ::sam_window_attention_v10 (:1222)
// and with them csrc/window_attention.cu and csrc/spatial_window_attention.cu
// of the first port, whose wrappers ran the bias rows, v2's dense (G, tp, tp)
// bias and the q scaling as plain PyTorch in front of each launch (at G =
// 3200 window-heads 0.71 ms of bias rows, 0.34 of q scaling, 1.39 of dense
// bias, against about 0.5 for the kernel).  Here the wrappers run nothing
// over q: the kernel reads q, k, v and the two (2 side - 1, 64) rel-pos
// tables, and forms what each mode needs itself.
//
// What each mode computes (the plain versions in
// ops/sam_flash_experiments.py round at the same places):
//   bias rows   bias_h[i, kh] = (q_i . table_h[y_i - kh + side - 1]) and
//               bias_w likewise with the query's grid column x_i: one more
//               wgmma per table (Q T^T, 64 x 32 x 64) whose column m of row
//               i is scattered to key row (column) y_i - m + side - 1, as
//               csrc/relpos_attention_sm90.cu does for K6.  Natural base,
//               rounded to bf16 (v1, v6, v7, v8, v3, v4, v5); f32, their sum
//               rounded to bf16 once per score (v2: the dense tensor's
//               values without the tensor); times log2(e) and rounded to
//               bf16 (v10).
//   q scale     at head_dim 64, scale = 2^-3, so bf16(q * 2^-3) = q * 2^-3
//               and bf16(q * 2^-3) . k = (q . k) * 2^-3 exactly: the modes
//               whose wrappers scaled and rounded q outside (v7, v8, v3, v2,
//               v4, v5) and those that scale the f32 scores (v1, v6) are one
//               function, s = (q . k) * 2^-3 + bias_h + bias_w, computed so.
//               The one exception is a q * 2^-3 below the smallest normal
//               bf16 (|q| < 2^-123), which the outside rounding would have
//               flushed or rounded as a subnormal; no activation comes near.
//               v10's factor scale * log2(e) is no power of two: its Q tile
//               is loaded into the wgmma A-fragment registers, scaled in f32
//               and rounded to bf16 there, and Q K^T is the register-A
//               product.
//   softmax     one-shot over the whole row, no running max: natural base
//               as exp2((s - max) log2 e), p rounded to bf16 for P V, the
//               denominator the f32 sum of the unrounded p clamped at 1e-30;
//               v4: s, s - max and p each rounded to bf16 and the sum of
//               the rounded p; v5: p rounded to bf16 and the sum of the
//               rounded p; v10: exp2(s - max) in the log2 domain.  (ex2 is
//               within 2 f32 ulps of exp: a rounded p differs from the plain
//               version's bf16(exp) only where exp lies that close to a
//               bf16 rounding boundary, by one bf16 step.)  The
//               pad keys of the JAX wrappers (-1e30; -1e4 for v4 and v5)
//               score against zero rows of v and so add nothing to the
//               numerator or the denominator: giving the keys at or beyond
//               T a score of -1e30 (v2: -inf) is the same function.  v10
//               also masks keys at or beyond grid_hw; its output beyond
//               grid_hw is 0.
//
// What bounds it on an H100: at G = 3200 window-heads (T = 196, hd = 64)
// the two products are 31.5 GFLOP (0.032 ms at the bf16 peak) and q, k, v
// and the output 321 MB (0.096 ms at 3.35 TB/s): bytes, by a factor of
// three, so each operand crosses the bus once and the loads must overlap
// the compute.  Next come the exp of 12.3 M scores on the SFUs and the
// softmax's ALU work.  The design:
//
// - persistent blocks, one an SM, each walking window-heads g = blockIdx.x,
//   + gridDim.x, ...; a producer warpgroup (one thread issuing, its
//   registers handed to the consumers with setmaxnreg) keeps the next
//   window-head's Q, K and V coming by TMA into a 2-stage ring (full /
//   empty mbarriers) while two consumer warpgroups work on the current one.
//   Over (G, T, 64) heads or (NW, nh, T, 64) views of a (NW T, 3C) qkv
//   tensor each operand is a T-row box of a 2D tensor map over its rows;
//   v10 reads the spatial head-major qkv (B, Hp, Wp, nh 3 64) through a 3D
//   map, box (64 columns, side, side) at column h 192 + {0, 64, 128}, which
//   lands in shared memory in the token order t = y side + x: the window
//   partition and the head split are the map's addressing;
// - the T rows of a box lie in buffers of 256 (Q) and 208 (K, V) rows, the
//   rows past T zeroed once, so the products see zero keys and values
//   there (a NaN left in shared memory would survive p = 0);
// - a warpgroup takes 64 query rows (T = 196: tiles 0-3, two each) and
//   holds their whole score row in registers: one wgmma m64n208k16 per k16
//   step, 104 f32 accumulators a thread; max, p and the row sums run over
//   the registers; p packed to bf16 is the A operand of O += P V, and V is
//   read through wgmma's transposed-B (MN-major) descriptor;
// - the bias rides the tensor cores, as the TPU kernels' augmented
//   products do: the Q K^T chain takes two more k16 steps, A = the tile's
//   bias rows [bias_h | bias_w | 0 ... | -1e30] in bf16 from registers, B =
//   a one-hot selection tile, key j having ones at columns j / side and
//   side + j % side (or at column 31 alone for the pad keys j >= T), built
//   once a block.  So the scores leave the products with the bias added and
//   the pad keys at -1e30 (exp gives 0): no per-score bias reads, adds or
//   masks.  The rows are scattered from the table product's accumulators
//   (a thread's rows belong to its quad) through a small shared buffer with
//   a __syncwarp.  Modes that add f32 bias rows to (q . k) * 2^-3 carry
//   them as 8 bias (exact in bf16) and scale the sum; v10 masks keys
//   beyond grid_hw by writing -1e30 into their bias_h or bias_w entry;
// - v2 alone rounds the f32 sum bias_h + bias_w per score, which no
//   product of bf16 operands gives: it keeps f32 rows in shared memory and
//   adds them score by score, each key's two entries from a table made
//   once a block (a pad key's both point at a -inf entry: no branch);
// - the tables arrive once per block (both are the layer's), 8 KB.
// Shared memory: 2 x 84 KB of ring, 8 KB of tables, 26 KB of selection
// tile, 2 x 5 KB of bias rows: ~213 KB, one block an SM.
//
// Layouts: element (g, t, d) of q is at (g / nh) q_b + (g % nh) q_h + t q_t
// + d, of k and v likewise with (s_b, s_h, s_t), of out with (o_b, o_h,
// o_t); v10 reads qkv (B, Hp, Wp, nh 3 64) and writes out (B, Hp, Wp, nh
// 64), both contiguous.
#include "sm90.cuh"

namespace {

constexpr int HD = 64, TN = 208, QROWS = 256, CONS = 2, STAGES = 2;
constexpr int THREADS = (CONS + 1) * 128;
constexpr int TABLE_ROWS = 32, MAX_SIDE = 14;
constexpr int Q_BYTES = QROWS * 128, KV_BYTES = TN * 128;
constexpr int STAGE_BYTES = Q_BYTES + 2 * KV_BYTES;
constexpr int TABLE_BYTES = TABLE_ROWS * 128;
constexpr int BA_LD = 40;   // bf16 a bias row: 80 bytes, conflict-free reads
constexpr int PAD_COL = 31;  // the bias column that holds -1e30
constexpr int SMEM_LIMIT = 232448;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float SCALE = 0.125f;  // 1 / sqrt(64)
constexpr float MASKED = -1e30f;
// the order is flmm_tpu_torch.ops.sam_flash_experiments.WINDOW_MODES
enum Mode {
  SCALE_AFTER = 0, SCALED_Q = 1, DENSE_BIAS = 2, SCALED_Q_BF16 = 3,
  SCALED_Q_ROUNDED_P = 4, SPATIAL_LOG2 = 5
};

struct Layout {
  int tables, sel, rows, bars, total;
};

// The ring, the tables, then either the selection tile and the bf16 bias
// rows of each consumer warpgroup, or (v2) its f32 bias rows.
__host__ __device__ inline Layout layout(int side, bool dense) {
  Layout l;
  l.tables = STAGES * STAGE_BYTES;
  l.sel = l.tables + 2 * TABLE_BYTES;
  l.rows = dense ? l.sel : l.sel + KV_BYTES;
  // v2: f32 rows, then each key's two row indices (uchar pairs)
  l.bars = l.rows + (dense ? CONS * 64 * (2 * side + 1) * 4 + TN * 2
                           : CONS * 64 * BA_LD * 2);
  l.total = l.bars + (2 * STAGES + 1) * 8;
  return l;
}

// Where a window-head lies.  Strided heads: q at row (g / nh) q_rows and
// column (g % nh) q_cols of its map, k and v likewise; v10: window (wy, wx)
// of image b, head h of the spatial grid.
struct Geometry {
  int G, nh, side, T;
  int q_rows, q_cols, kv_rows, kv_cols;
  long long o_b, o_h, o_t;
  int Hp, Wp, nwy, nwx, grid_hw;
  float alpha;  // v10: q's factor, scale * log2(e)
};

struct Spot {
  int b, wy, wx, h;
};

__device__ __forceinline__ Spot spatial_spot(const Geometry& gm, int g) {
  Spot s;
  s.h = g % gm.nh;
  const int w = g / gm.nh;
  s.wx = w % gm.nwx;
  s.wy = (w / gm.nwx) % gm.nwy;
  s.b = w / (gm.nwx * gm.nwy);
  return s;
}

// p from the accumulator of a score (q . k + 8 bias in the natural-base
// modes, q' . k + bias for v10, the whole score for v2) and its row max;
// v4's is formed in softmax_rows.
template <int MODE>
__device__ __forceinline__ float prob(float s, float mx) {
  if constexpr (MODE == SPATIAL_LOG2) return sm90::ex2(s - mx);
  else if constexpr (MODE == DENSE_BIAS) return sm90::ex2((s - mx) * LOG2E);
  else return sm90::ex2((s - mx) * (SCALE * LOG2E));
}

// The A fragment (k16 step) of 64 rows of 64 bf16 columns in the 128-byte
// swizzle: rows r0 and r0 + 8, columns 16 kk + c2 (+1, +8, +9), each pair
// times `scale` and rounded to bf16.
__device__ __forceinline__ void swizzled_a(uint32_t* a,
                                           const unsigned char* tile, int r0,
                                           int c2, int kk, float scale) {
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const int row = r0 + (f & 1) * 8, chunk = 2 * kk + (f >> 1);
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(
        tile + row * 128 + ((chunk ^ (row & 7)) << 4) + c2 * 2);
    const float2 x =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
    a[f] = pack2(x.x * scale, x.y * scale);
  }
}

// One warp's 16 rows of a tile, from the score accumulators: v2's scale and
// bias (the pad keys at -inf), the row max (v4: of the scores rounded to
// bf16, in bf16x2 pairs); p, packed to bf16 pairs (the score accumulators
// of 16 keys are one A fragment of P V: pair j of a row is pa[j / 2][2 (j %
// 2) + row]), and this thread's share of the row sums (v4, v5: of the
// rounded p).
template <int MODE>
__device__ __forceinline__ void softmax_rows(float* sc, uint32_t (*pa)[4],
                                             float& l0, float& l1,
                                             const float* B0, const float* B1,
                                             const uchar4* kidx4) {
  constexpr bool BF16 = MODE == SCALED_Q_BF16;
  constexpr bool ROUNDED_SUM = BF16 || MODE == SCALED_Q_ROUNDED_P;
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
  __nv_bfloat162 sb[BF16 ? TN / 4 : 1];  // v4: the rounded scores, pairs
  __nv_bfloat162 mb[2];
  if constexpr (BF16)
    mb[0] = mb[1] = __float2bfloat162_rn(-CUDART_INF_F);
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    if constexpr (MODE == DENSE_BIAS) {
      const uchar4 ki = kidx4[4 * j];  // keys 8 j + c2 and + 1
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int h = e ? ki.z : ki.x, w = e ? ki.w : ki.y;
        sc[4 * j + e] = fmaf(sc[4 * j + e], SCALE, round_bf16(B0[h] + B0[w]));
        sc[4 * j + 2 + e] =
            fmaf(sc[4 * j + 2 + e], SCALE, round_bf16(B1[h] + B1[w]));
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float a = sc[4 * j + 2 * r], b = sc[4 * j + 2 * r + 1];
      if constexpr (BF16) {
        sb[2 * j + r] = __floats2bfloat162_rn(a * SCALE, b * SCALE);
        mb[r] = __hmax2(mb[r], sb[2 * j + r]);
      } else {
        mx[r] = fmaxf(mx[r], fmaxf(a, b));
      }
    }
  }
  if constexpr (BF16)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      mx[r] = fmaxf(__low2float(mb[r]), __high2float(mb[r]));
  // a row with no valid key cannot occur (key t is valid for row t)
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < TN / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float p0, p1;
      if constexpr (BF16) {
        // s - max rounded (a bf16 subtraction), then exp rounded below
        const float2 d = __bfloat1622float2(
            __hsub2(sb[2 * j + r], __float2bfloat162_rn(mx[r])));
        p0 = sm90::ex2(d.x * LOG2E);
        p1 = sm90::ex2(d.y * LOG2E);
      } else {
        p0 = prob<MODE>(sc[4 * j + 2 * r], mx[r]);
        p1 = prob<MODE>(sc[4 * j + 2 * r + 1], mx[r]);
      }
      const __nv_bfloat162 pp = __floats2bfloat162_rn(p0, p1);
      if constexpr (ROUNDED_SUM) {
        const float2 q = __bfloat1622float2(pp);
        l[r] += q.x + q.y;
      } else {
        l[r] += p0 + p1;
      }
      pa[j / 2][2 * (j % 2) + r] = *reinterpret_cast<const uint32_t*>(&pp);
    }
  l0 += l[0];
  l1 += l[1];
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
window_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_th,
                   const __grid_constant__ CUtensorMap map_tw,
                   const Geometry gm, bf16* __restrict__ out) {
  constexpr bool SPATIAL = MODE == SPATIAL_LOG2;
  constexpr bool DENSE = MODE == DENSE_BIAS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  const int side = gm.side, T = gm.T, tiles = (T + 63) / 64;
  const Layout L = layout(side, DENSE);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + STAGES;
  uint64_t* tbar = empty + STAGES;
  const int tid = threadIdx.x, wg = tid / 128;

  // the rows past T of every buffer, which TMA never writes: zeros
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int s = 0; s < STAGES; ++s) {
    unsigned char* st = smem + s * STAGE_BYTES;
    for (int i = tid; i < (QROWS - T) * 8; i += THREADS)
      *reinterpret_cast<uint4*>(st + T * 128 + i * 16) = zero;
    for (int i = tid; i < (TN - T) * 8; i += THREADS) {
      *reinterpret_cast<uint4*>(st + Q_BYTES + T * 128 + i * 16) = zero;
      *reinterpret_cast<uint4*>(st + Q_BYTES + KV_BYTES + T * 128 + i * 16) =
          zero;
    }
  }
  if constexpr (DENSE) {
    // each key's bias row entries: j / side and side + j % side, a pad key
    // the entry 2 side of every row, -inf
    unsigned char* kidx = smem + L.rows + CONS * 64 * (2 * side + 1) * 4;
    for (int key = tid; key < TN; key += THREADS) {
      kidx[2 * key] = key < T ? key / side : 2 * side;
      kidx[2 * key + 1] = key < T ? side + key % side : 2 * side;
    }
    float* rows = reinterpret_cast<float*>(smem + L.rows);
    for (int r = tid; r < CONS * 64; r += THREADS)
      rows[r * (2 * side + 1) + 2 * side] = -CUDART_INF_F;
  } else {
    // the selection tile (K-major, 208 keys x 64 columns, 128-byte
    // swizzle): key j < T selects bias columns j / side and side + j %
    // side, a pad key the -1e30 column
    for (int i = tid; i < TN * 64; i += THREADS) {
      const int key = i / 64, c = i % 64;
      const bool one = key < T ? c == key / side || c == side + key % side
                               : c == PAD_COL;
      *reinterpret_cast<bf16*>(smem + L.sel + key * 128 +
                               (((c / 8) ^ (key % 8)) << 4) + (c % 8) * 2) =
          __float2bfloat16_rn(one ? 1.f : 0.f);
    }
    // the bias rows: zeros, -1e30 in the pad column
    bf16* rows = reinterpret_cast<bf16*>(smem + L.rows);
    for (int i = tid; i < CONS * 64 * BA_LD; i += THREADS)
      rows[i] = __float2bfloat16_rn(i % BA_LD == PAD_COL ? MASKED : 0.f);
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONS * 4);  // one arrival a warp
    }
    sm90::mbar_init(tbar, 1);
    sm90::fence_barrier_init();
  }
  sm90::fence_proxy_async();
  __syncthreads();

  if (wg == CONS) {
    // producer warpgroup: one thread loads the tables once, then keeps the
    // ring of window-heads full
    sm90::setmaxnreg_dec<40>();
    if (tid == CONS * 128) {
      sm90::mbar_expect_tx(tbar, 2 * TABLE_BYTES);
      sm90::tma_load_2d(smem + L.tables, &map_th, tbar, 0, 0);
      sm90::tma_load_2d(smem + L.tables + TABLE_BYTES, &map_tw, tbar, 0, 0);
      int i = 0;
      for (int g = blockIdx.x; g < gm.G; g += gridDim.x, ++i) {
        const int s = i % STAGES;
        sm90::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        unsigned char* st = smem + s * STAGE_BYTES;
        sm90::mbar_expect_tx(&full[s], 3 * T * 128);
        if constexpr (SPATIAL) {
          const Spot p = spatial_spot(gm, g);
          const int col = p.h * 3 * HD, x = p.wx * side,
                    y = p.b * gm.Hp + p.wy * side;
          sm90::tma_load_3d(st, &map_q, &full[s], col, x, y);
          sm90::tma_load_3d(st + Q_BYTES, &map_k, &full[s], col + HD, x, y);
          sm90::tma_load_3d(st + Q_BYTES + KV_BYTES, &map_v, &full[s],
                            col + 2 * HD, x, y);
        } else {
          const int img = g / gm.nh, head = g % gm.nh;
          sm90::tma_load_2d(st, &map_q, &full[s], head * gm.q_cols,
                            img * gm.q_rows);
          sm90::tma_load_2d(st + Q_BYTES, &map_k, &full[s],
                            head * gm.kv_cols, img * gm.kv_rows);
          sm90::tma_load_2d(st + Q_BYTES + KV_BYTES, &map_v, &full[s],
                            head * gm.kv_cols, img * gm.kv_rows);
        }
      }
    }
    return;
  }
  sm90::setmaxnreg_inc<232>();

  // This thread's two rows of a 64-row tile (accumulator rows lane / 4 and
  // lane / 4 + 8 of its warp's 16) and its column pair (lane % 4) * 2 of
  // every 8.
  const int warp = (tid % 128) / 32, lane = tid % 32, c2 = (lane % 4) * 2;
  const int r0 = warp * 16 + lane / 4;
  const unsigned char* tables = smem + L.tables;
  // v2: its quad's two f32 bias rows (odd stride against bank conflicts,
  // -inf at the end) and the keys' entries in them
  const int bld = 2 * side + 1;
  float* B0 = reinterpret_cast<float*>(smem + L.rows) + (wg * 64 + r0) * bld;
  float* B1 = B0 + 8 * bld;
  const uchar4* kidx4 = reinterpret_cast<const uchar4*>(
      smem + L.rows + CONS * 64 * bld * 4 + 2 * c2);
  // the other modes: this warpgroup's bf16 bias rows, the A operand of the
  // last two k16 steps of Q K^T
  bf16* Bb = reinterpret_cast<bf16*>(smem + L.rows) + wg * 64 * BA_LD;
  sm90::mbar_wait(tbar, 0);

  int i = 0;
  for (int g = blockIdx.x; g < gm.G; g += gridDim.x, ++i) {
    const int s = i % STAGES;
    sm90::mbar_wait(&full[s], (i / STAGES) & 1);
    const unsigned char* Qs = smem + s * STAGE_BYTES;
    const unsigned char* Ks = Qs + Q_BYTES;
    const unsigned char* Vs = Ks + KV_BYTES;
    // the key grid rows and columns a row may see (v10: inside grid_hw)
    // and where token t's output goes
    int lim_h = side, lim_w = side;
    bf16* ob;
    long long tok_row = 0;  // v10: elements between two token rows
    if constexpr (SPATIAL) {
      const Spot p = spatial_spot(gm, g);
      lim_h = min(side, gm.grid_hw - p.wy * side);
      lim_w = min(side, gm.grid_hw - p.wx * side);
      tok_row = (long long)gm.Wp * gm.nh * HD;
      ob = out + ((long long)p.b * gm.Hp + p.wy * side) * tok_row +
           (long long)p.wx * side * gm.nh * HD + p.h * HD;
    } else {
      ob = out + (long long)(g / gm.nh) * gm.o_b +
           (long long)(g % gm.nh) * gm.o_h;
    }

    for (int tile = wg; tile < tiles; tile += CONS) {
      const unsigned char* Qt = Qs + tile * 64 * 128;
      const int t0 = tile * 64 + r0, t1 = t0 + 8;
      // a warp whose 16 rows all lie past T (T = 196: three of the fourth
      // tile's four) takes part in the products and skips the rest
      const bool live = tile * 64 + warp * 16 < T;

      // one chain: the table product Q [T_h ; T_w]^T (64 x 64, the two
      // tables one 64-row tile) and S = Q K^T over all 208 key columns
      float acc[2 * TABLE_ROWS / 2];
      float sc[TN / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        sm90::wgmma_ss_n64<0>(acc, sm90::desc_kmajor(Qt + kk * 32),
                              sm90::desc_kmajor(tables + kk * 32), kk > 0);
      if constexpr (SPATIAL) {
        // Q into A fragments, times alpha and rounded: the register product
        uint32_t qa[HD / 16][4];
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          swizzled_a(qa[kk], Qt, r0, c2, kk, gm.alpha);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          sm90::wgmma_rs_n208<0>(sc, qa[kk], sm90::desc_kmajor(Ks + kk * 32),
                                 kk > 0);
      } else {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          sm90::wgmma_ss_n208<0>(sc, sm90::desc_kmajor(Qt + kk * 32),
                                 sm90::desc_kmajor(Ks + kk * 32), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs<TABLE_ROWS>(acc);
      sm90::fence_regs<TN / 2>(sc);

      // the bias rows of this tile: column m of table tab in row t is key
      // row (column) y - m + side - 1, y the query's grid row (column)
#pragma unroll
      for (int tab = 0; tab < 2 && live; ++tab) {
        const int lim = tab == 0 ? lim_h : lim_w;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = min(h ? t1 : t0, T - 1);  // rows past T: not stored
          const int y = (tab == 0 ? t / side : t % side) + side - 1;
          const int row = r0 + 8 * h;
#pragma unroll
          for (int j = 0; j < TABLE_ROWS / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kk = y - (8 * j + c2 + e);
              if (kk < 0 || kk >= side) continue;
              const float x = acc[4 * (tab * TABLE_ROWS / 8 + j) + 2 * h + e];
              if constexpr (DENSE) {
                (h ? B1 : B0)[tab * side + kk] = x;
              } else {
                // natural-base modes: 8 bf16(x) = bf16(8 x), exact
                const float b = SPATIAL ? x * LOG2E : x * 8.f;
                Bb[row * BA_LD + tab * side + kk] =
                    __float2bfloat16_rn(kk < lim ? b : MASKED);
              }
            }
        }
      }
      __syncwarp();

      if constexpr (!DENSE) {
        // + the bias rows through the selection tile: two more k16 steps
        uint32_t ba[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
#pragma unroll
          for (int f = 0; f < 4; ++f)
            ba[kk][f] = *reinterpret_cast<const uint32_t*>(
                Bb + (r0 + (f & 1) * 8) * BA_LD + 16 * kk + (f >> 1) * 8 +
                c2);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          sm90::wgmma_rs_n208<0>(
              sc, ba[kk], sm90::desc_kmajor(smem + L.sel + kk * 32), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs<TN / 2>(sc);
      }

      // p packed to bf16, 16 keys one A fragment of P V, and its row sums
      uint32_t pa[TN / 16][4];
      float l0 = 0.f, l1 = 0.f;
      if (live) {
        softmax_rows<MODE>(sc, pa, l0, l1, B0, B1, kidx4);
      } else {
#pragma unroll
        for (int kk = 0; kk < TN / 16; ++kk)
#pragma unroll
          for (int f = 0; f < 4; ++f) pa[kk][f] = 0u;
      }

      // O = P V
      float o[HD / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TN / 16; ++kk)
        sm90::wgmma_rs_n64<1>(o, pa[kk],
                              sm90::desc_mnmajor(Vs + kk * 2048, KV_BYTES),
                              kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs<HD / 2>(o);

      const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
      const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = h ? t1 : t0;
        if (t >= T) continue;
        const float inv = h ? inv1 : inv0;
        bf16* dst;
        bool inside = true;
        if constexpr (SPATIAL) {
          const int ty = t / side, tx = t % side;
          inside = ty < lim_h && tx < lim_w;
          dst = ob + ty * tok_row + (long long)tx * gm.nh * HD;
        } else {
          dst = ob + t * gm.o_t;
        }
#pragma unroll
        for (int dt = 0; dt < HD / 8; ++dt)
          *reinterpret_cast<uint32_t*>(dst + dt * 8 + c2) =
              inside ? pack2(o[4 * dt + 2 * h] * inv,
                             o[4 * dt + 2 * h + 1] * inv)
                     : 0u;
      }
      __syncwarp();  // the quad's bias rows are read before the next tile
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }
}

template <int MODE>
int launch(const CUtensorMap* maps, const Geometry& gm, bf16* out,
           cudaStream_t stream) {
  auto kernel = window_sm90_kernel<MODE>;
  // + the alignment
  const int smem = layout(gm.side, MODE == DENSE_BIAS).total + 1024;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  // per device: the shared memory granted so far and the SM count
  static int granted[64], sms[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem > granted[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess && sms[dev] == 0)
      e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (e != cudaSuccess) return (int)e;
    granted[dev] = smem;
  }
  kernel<<<gm.G < sms[dev] ? gm.G : sms[dev], THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], gm, out);
  return (int)cudaGetLastError();
}

int table_maps(CUtensorMap* maps, const void* table_h, const void* table_w,
               int side) {
  if (table_h == nullptr || table_w == nullptr)
    return (int)cudaErrorInvalidValue;
  const int n = 2 * side - 1;
  int e = make_tile_map(&maps[0], table_h, HD, n, HD, TABLE_ROWS);
  if (!e) e = make_tile_map(&maps[1], table_w, HD, n, HD, TABLE_ROWS);
  return e;
}

}  // namespace

// (G, T, 64) window-heads with strides, modes 0-4; table_h, table_w the
// (2 side - 1, 64) rel-pos tables in bf16; 1 <= side <= 14.
extern "C" int flmm_window_attention_sm90(
    const void* q, long long q_b, long long q_h, long long q_t, const void* k,
    const void* v, long long s_b, long long s_h, long long s_t, int nh,
    const void* table_h, const void* table_w, int side, int G, int T,
    int mode, void* out, long long o_b, long long o_h, long long o_t,
    void* stream) {
  if (G <= 0 || nh <= 0 || G % nh || side < 1 || side > MAX_SIDE ||
      side * side != T || mode < SCALE_AFTER || mode > SCALED_Q_ROUNDED_P ||
      o_b % 2 || o_h % 2 || o_t % 2)
    return (int)cudaErrorInvalidValue;
  if (nh == 1) q_h = s_h = 0;
  CUtensorMap maps[5] = {};
  int e = make_head_map(&maps[0], q, q_b, q_h, q_t, nh, G, T, T);
  if (!e) e = make_head_map(&maps[1], k, s_b, s_h, s_t, nh, G, T, T);
  if (!e) e = make_head_map(&maps[2], v, s_b, s_h, s_t, nh, G, T, T);
  if (!e) e = table_maps(&maps[3], table_h, table_w, side);
  if (e) return e;
  Geometry gm = {};
  gm.G = G;
  gm.nh = nh;
  gm.side = side;
  gm.T = T;
  gm.q_rows = (int)(q_b / q_t);
  gm.q_cols = (int)q_h;
  gm.kv_rows = (int)(s_b / s_t);
  gm.kv_cols = (int)s_h;
  gm.o_b = o_b;
  gm.o_h = o_h;
  gm.o_t = o_t;
  const cudaStream_t st = (cudaStream_t)stream;
  bf16* o = (bf16*)out;
  switch (mode) {
    case DENSE_BIAS: return launch<DENSE_BIAS>(maps, gm, o, st);
    case SCALED_Q_BF16: return launch<SCALED_Q_BF16>(maps, gm, o, st);
    case SCALED_Q_ROUNDED_P: return launch<SCALED_Q_ROUNDED_P>(maps, gm, o, st);
    // SCALE_AFTER and SCALED_Q: one function at head_dim 64 (see above)
    default: return launch<SCALE_AFTER>(maps, gm, o, st);
  }
}

// v10: qkv (B, Hp, Wp, nh * 192) head-major [q_h | k_h | v_h], out (B, Hp,
// Wp, nh * 64), both contiguous; Hp and Wp multiples of side <= 14, 0 <
// grid_hw <= Hp, Wp; alpha = scale * log2(e).
extern "C" int flmm_spatial_window_attention_sm90(
    const void* qkv, const void* table_h, const void* table_w, int B, int Hp,
    int Wp, int nh, int side, int grid_hw, float alpha, void* out,
    void* stream) {
  if (B <= 0 || nh <= 0 || side < 1 || side > MAX_SIDE || Hp <= 0 ||
      Wp <= 0 || Hp % side || Wp % side || grid_hw <= 0 || grid_hw > Hp ||
      grid_hw > Wp)
    return (int)cudaErrorInvalidValue;
  const long long cols = (long long)nh * 3 * HD;
  CUtensorMap maps[5] = {};
  int e = make_tile_map_3d(&maps[0], qkv, cols, Wp, cols, (long long)B * Hp,
                           cols * Wp, side, side);
  if (!e) e = table_maps(&maps[3], table_h, table_w, side);
  if (e) return e;
  maps[1] = maps[2] = maps[0];
  Geometry gm = {};
  gm.nh = nh;
  gm.side = side;
  gm.T = side * side;
  gm.Hp = Hp;
  gm.Wp = Wp;
  gm.nwy = Hp / side;
  gm.nwx = Wp / side;
  gm.grid_hw = grid_hw;
  gm.alpha = alpha;
  const long long G = (long long)B * gm.nwy * gm.nwx * nh;
  if (G > (1ll << 30)) return (int)cudaErrorInvalidValue;
  gm.G = (int)G;
  return launch<SPATIAL_LOG2>(maps, gm, (bf16*)out, (cudaStream_t)stream);
}
