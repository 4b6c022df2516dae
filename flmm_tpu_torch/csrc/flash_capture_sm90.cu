// Causal flash attention with key-validity holes that also emits the
// mean-merged text->image attention per mask (K5), or the raw probabilities
// of every query row over the image keys (K9), on Hopper's wgmma + TMA
// machinery, without an S x S matrix.
//
// Replaces flmm_tpu/ops/flash_attention.py::flash_attention_with_merged_capture
// (K5, the pallas_call at :246) and ::flash_attention_with_capture (K9, the
// pallas_call at :324), and the first port's mma.sync kernels of
// csrc/flash_capture.cu (64-key K and V^T tiles staged synchronously, V
// transposed by scalar stores: 2.753 ms at the LLaVA-NeXT shape, 18x its
// bound, chip_smoke.py phase 3 on an NVIDIA H100 80GB HBM3, 700.00 W).
//
//   out[b, h, i]        = sum_j p(i, j) v[b, h, j]
//   merged[b, h, m, n]  = sum_i mm[b, i, m] p(i, img_start + n),  n < n_img
//   probs[b, h, i, n]   = p(i, img_start + n)
//
// with p the softmax over keys j <= i with key_valid[b, j] (a row with no
// such key gives p = 0 and out = 0, the TPU kernel's guard, :103 / :168).
//
// What bounds it on an H100: at the LLaVA-NeXT shape (B = 2, H = 32,
// S = 3200, hd = 128) the causal products are ~170 GFLOP a layer, 0.17 ms
// of tensor-core time against 0.03 ms of operand bytes, so operations bound
// pass 1, and next to them the exp2 of the scores on the SFUs; the merge of
// the caption rows is small.  K9's f32 side output (113 MB at the
// DeepSeek-VL-1.3B aligned shape) makes bytes bound it.  The TPU kernels
// keep a (128, n_img_pad) f32 strip per query block in VMEM, rescaled at
// every key block, and add the merged product into one output across a
// sequential grid; an SM has 228 KB and blocks run in no order.  So the
// work is two passes, each reading q / k / v in place through 4D tensor
// maps (column, token, head, batch) of their strided views:
//
// 1. flash_fwd: a block owns 128 query rows of one (b, h), 64 per consumer
//    warpgroup, longest rows first.  A producer warpgroup hands its
//    registers to the consumers (setmaxnreg 40 / 232); one of its warps
//    keeps TMA loads of 128-key K and V tiles in flight through a ring of
//    three stages with full / empty mbarriers, and copies each tile's
//    key_valid bytes beside it with a flag for a tile without holes.  hd
//    128 comes as two 64-column boxes in the 128-byte swizzle: S = Q K^T is
//    8 k16 steps of wgmma m64n128; p, rounded to bf16, is the register A
//    operand of O += P V, two m64n64 products a k16 step, one on each V box
//    through the MN-major descriptor.  Each consumer issues S(t) with
//    P(t - 1) V(t - 1) and runs the softmax of tile t while the latter
//    runs; the two warpgroups take turns to issue (named barriers), so one's
//    softmax lies beside the other's products.  Only the key tiles at or
//    below the diagonal are visited; causality is masked by index in the
//    diagonal tile only, holes (-inf before the running max) only in a tile
//    that has one.  A row that has seen no valid key keeps p = 0 and a
//    rescale of 0, never exp2(-inf + inf).  GQA: the k / v maps index kv
//    head h / rep, nothing is repeated, and the rep query heads of one kv
//    head are neighbours in the grid, so their blocks share K and V in L2.
//    It writes out as (B, S, H, hd) and the row log-sum-exp in base 2 of the
//    scaled scores, -inf for a row without a visible key.
// 2a. merged capture: one warpgroup per (b, h, 64 image keys, chunk of up
//    to 32 masks), the K tile loaded once by TMA.  A first small kernel
//    flags the 64-row query blocks
//    whose merge rows are not all zero (for F-LMM only the caption rows
//    are); the block compacts the flags of the query blocks that see its
//    keys into a list and walks it in order, prefetching the next Q tile by
//    TMA into a second stage.  Per query block: S^T = K Q^T on wgmma, p^T =
//    exp2(s alpha - lse) under the causal and key masks, and acc (64 keys x
//    M) += P^T mm by wgmma with P^T from registers and mm^T staged as bf16 in
//    the 128-byte swizzle, hi + lo pairs in three products (hi hi, lo hi,
//    hi lo), so the merge keeps ~f32 accuracy where the TPU kernel rounded
//    both to bf16.  Any M: up to 32 masks take one block, padded to N = 8,
//    16 or 32; more take ceil(M / 32) blocks side by side in the grid, each
//    on the columns [32 c, 32 c + w) of mm (row stride M; a partial last
//    chunk stages zeros past w) and writing those rows of merged.  Each
//    chunk recomputes S^T and p^T for the flagged blocks only (the caption
//    rows), the cost of keeping acc at 16 registers a thread.  Each output
//    element has one owner and one summation order: no atomics, no partial
//    buffer, the same bits on every run.
// 2b. raw capture: one warpgroup per (b, h, 64 query rows) walks the image
//    key tiles at or below its diagonal (TMA, two stages), recomputes Q K^T
//    on wgmma and stages exp2(s alpha - lse) under the masks as an f32 tile
//    in shared memory, which a TMA store writes out while the next tile is
//    computed; the tiles above the diagonal are stored from one zeroed tile
//    without a product.  Columns past n_img are neither read nor written
//    (the store clips at the map's extent).  An n_img that is not a
//    multiple of 4 leaves rows that TMA cannot address; there the threads
//    copy the staged tile out with plain stores.
//
// Numerics: q and k are read as they are, scale * log2(e) goes onto the f32
// scores; scores, softmax, accumulation and lse in f32; p rounded to bf16
// for P V; the row sum of the unrounded p divides at the end.
//
// Query rows of one rank (K5 under sequence sharding): q may hold the Sq
// rows [q_off, q_off + Sq) of the S keys, both multiples of 128.  Every
// causal compare is by global row (local row + q_off); q, out, lse, mm and
// the flags are addressed by local row; k, v and key_valid cover all S.
// Pass 1 walks the key tiles up to each local tile's global diagonal,
// pass 2a the local query blocks that see its keys, and its merged capture
// is this rank's share of the sum over rows.  K9 takes Sq = S, q_off = 0.
//
// Layout: element (b, h, t, d) of q is at b * q_b + h * q_h + t * q_t + d
// (likewise k, v with their own strides and head h / (H / KV), and out);
// key_valid is (B, S) bytes, mm is (B, Sq, M) f32, lse is (B * H, Sq) f32
// scratch, flags (B, Sq / 64) bytes of scratch and merged (B, H, M, n_img)
// f32.  Strides are multiples of 8 elements, bases 16-byte aligned.
#include "sm90.cuh"

namespace {

constexpr int HD = 128;
constexpr int BOX = 64 * 128;   // one box: 64 rows of 64 bf16
constexpr int TILE = 2 * BOX;   // 64 rows of a head: columns 0-63, 64-127
constexpr int BLOCK = 128;      // the contract's alignment of S, img_start
constexpr int SMEM_LIMIT = 232448;
constexpr float LOG2E = 1.4426950408889634f;

// Pass 1: consumer warpgroups of 64 query rows, 128-key tiles, stages of
// the K / V ring and the byte offsets of the 1024-aligned dynamic shared
// memory: the Q tiles, per stage a K and a V tile (each two 128-row boxes,
// columns 0-63 then 64-127), per stage the tile's key_valid bytes and its
// flag, the mbarriers.
constexpr int P1_CONS = 2;
constexpr int P1_THREADS = (P1_CONS + 1) * 128;
constexpr int P1_STAGES = 3;
constexpr int KV_TILE = 2 * 128 * 128;  // 128 keys x 128 columns of bf16
constexpr int P1_STAGE = 2 * KV_TILE;
constexpr int P1_VALID = P1_CONS * TILE + P1_STAGES * P1_STAGE;
constexpr int P1_BARS = P1_VALID + P1_STAGES * 256;
constexpr int P1_SMEM = P1_BARS + (2 * P1_STAGES + 1) * 8 + 1024;

// The S tile of a warpgroup over 64 keys, A K-major from `a`, B K-major
// from `b`, both head rows of two boxes: 8 k16 steps, waited for.
__device__ __forceinline__ void scores64(float* sc, const unsigned char* a,
                                         const unsigned char* b) {
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int off = (kk / 4) * BOX + (kk % 4) * 32;
    sm90::wgmma_ss_n64<0>(sc, sm90::desc_kmajor(a + off),
                          sm90::desc_kmajor(b + off), kk > 0);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs<32>(sc);
}

__global__ void __launch_bounds__(P1_THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const unsigned char* __restrict__ key_valid, int H,
                      int rep, int S, int Sq, int q_off, float alpha,
                      bf16* __restrict__ out,
                      long long o_b, long long o_h, long long o_t,
                      float* __restrict__ lse) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P1_BARS);
  uint64_t* empty = full + P1_STAGES;
  uint64_t* qbar = empty + P1_STAGES;
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  // the local rows, longest first; q0 + q_off is the global one
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BLOCK;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int KT = (q0 + q_off) / 128 + 1;  // key tiles; the last is diagonal

  if (tid == 0) {
    for (int s = 0; s < P1_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], P1_CONS * 4);  // one arrival a warp
    }
    sm90::mbar_init(qbar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == P1_CONS) {
    sm90::setmaxnreg_dec<40>();
    if (tid < P1_CONS * 128 + 32) {
      // the producer warp: lane 0 loads Q, then keeps the ring full; the
      // lanes copy each tile's 128 key_valid bytes and flag a tile without
      // holes, before lane 0's arrival releases them
      const int hk = h / rep;
      const unsigned* vrow =
          reinterpret_cast<const unsigned*>(key_valid + (long long)b * S);
      if (lane == 0) {
        sm90::mbar_expect_tx(qbar, P1_CONS * TILE);
        for (int c = 0; c < P1_CONS; ++c)
          for (int x = 0; x < 2; ++x)
            sm90::tma_load_4d(smem + c * TILE + x * BOX, &map_q, qbar, 64 * x,
                              q0 + 64 * c, h, b);
      }
      for (int t = 0; t < KT; ++t) {
        const int s = t % P1_STAGES;
        const unsigned v = vrow[t * 32 + lane];
        sm90::mbar_wait(&empty[s], ((t / P1_STAGES) & 1) ^ 1);
        unsigned char* ok = smem + P1_VALID + s * 256;
        reinterpret_cast<unsigned*>(ok)[lane] = v;
        const bool whole = __all_sync(0xffffffffu, v == 0x01010101u);
        if (lane == 0) ok[128] = whole;
        __syncwarp();
        if (lane == 0) {
          unsigned char* st = smem + P1_CONS * TILE + s * P1_STAGE;
          sm90::mbar_expect_tx(&full[s], P1_STAGE);
          for (int x = 0; x < 2; ++x) {
            sm90::tma_load_4d(st + x * (KV_TILE / 2), &map_k, &full[s],
                              64 * x, t * 128, hk, b);
            sm90::tma_load_4d(st + KV_TILE + x * (KV_TILE / 2), &map_v,
                              &full[s], 64 * x, t * 128, hk, b);
          }
        }
      }
    }
    return;
  }
  sm90::setmaxnreg_inc<232>();

  // This thread's two local rows (accumulator rows lane / 4 and lane / 4 + 8
  // of its warp's 16), their global rows and its column pair (lane % 4) * 2
  // of every 8.
  const int warp = (tid % 128) / 32, c2 = (lane % 4) * 2;
  const int t0 = q0 + wg * 64 + warp * 16 + lane / 4, t1 = t0 + 8;
  const int g0 = t0 + q_off, g1 = t1 + q_off;
  const unsigned char* Qw = smem + wg * TILE;

  float o[64];  // O's columns 0-63, then 64-127
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  float sc[64];
  uint32_t pa[8][4];

  auto stage = [&](int t) {
    return smem + P1_CONS * TILE + (t % P1_STAGES) * P1_STAGE;
  };
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[t % P1_STAGES]);
  };
  auto issue_s = [&](int t) {
    const unsigned char* Ks = stage(t);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      sm90::wgmma_ss_n128<0>(
          sc, sm90::desc_kmajor(Qw + (kk / 4) * BOX + (kk % 4) * 32),
          sm90::desc_kmajor(Ks + (kk / 4) * (KV_TILE / 2) + (kk % 4) * 32),
          kk > 0);
    sm90::wgmma_commit();
  };
  // O += P V: per k16 step of keys, columns 0-63 from V's first box, 64-127
  // from its second
  auto issue_pv = [&](int t) {
    const unsigned char* Vs = stage(t) + KV_TILE;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      sm90::wgmma_rs_n64<1>(o, pa[kk],
                            sm90::desc_mnmajor(Vs + kk * 2048, BOX), 1);
      sm90::wgmma_rs_n64<1>(
          o + 32, pa[kk],
          sm90::desc_mnmajor(Vs + KV_TILE / 2 + kk * 2048, BOX), 1);
    }
    sm90::wgmma_commit();
  };
  // tile t's masks and online softmax in base 2: sc becomes p, (r0, r1)
  // the rescale of the earlier tiles.  The max of the raw scores times
  // alpha > 0 is the max of the scaled ones
  auto softmax = [&](int t, float& r0, float& r1) {
    const unsigned char* ok = smem + P1_VALID + (t % P1_STAGES) * 256;
    const bool on_diag = t == KT - 1;
    if (on_diag || !ok[128]) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint32_t pair =
            *reinterpret_cast<const uint16_t*>(ok + 8 * j + c2);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = t * 128 + 8 * j + c2 + e;
          const bool valid = (pair >> (8 * e)) & 0xff;
          if (!valid || (on_diag && key > g0)) sc[4 * j + e] = -CUDART_INF_F;
          if (!valid || (on_diag && key > g1))
            sc[4 * j + 2 + e] = -CUDART_INF_F;
        }
      }
    }
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx0 = fmaxf(mx0, sc[4 * j + e]);
        mx1 = fmaxf(mx1, sc[4 * j + 2 + e]);
      }
    const float mn0 = fmaxf(m0, quad_max(mx0) * alpha);
    const float mn1 = fmaxf(m1, quad_max(mx1) * alpha);
    const float mb0 = mn0 == -CUDART_INF_F ? 0.f : mn0;
    const float mb1 = mn1 == -CUDART_INF_F ? 0.f : mn1;
    r0 = sm90::ex2(m0 - mb0);
    r1 = sm90::ex2(m1 - mb1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = sm90::ex2(fmaf(sc[4 * j + e], alpha, -mb0));
        sc[4 * j + 2 + e] = sm90::ex2(fmaf(sc[4 * j + 2 + e], alpha, -mb1));
        ps0 += sc[4 * j + e];
        ps1 += sc[4 * j + 2 + e];
      }
    l0 = l0 * r0 + ps0;  // this thread's columns; summed over the quad at
    l1 = l1 * r1 + ps1;  // the end
  };
  // p, rounded to bf16: the score accumulators of 16 keys are one A
  // fragment of P V
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      pa[kk][0] = pack2(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack2(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack2(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack2(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };
  // The warpgroups take turns to issue their products: named barrier 1 + w
  // opens warpgroup w's turn, and warpgroup 1 opens the first turn of 0.
  // Both take KT turns; warpgroup 1 leaves its last opening out, so that no
  // barrier is left waiting.
  auto turn = [&]() { sm90::named_sync(1 + wg, 256); };
  auto pass_turn = [&](bool last) {
    if (wg == 0 || !last) sm90::named_arrive(2 - wg, 256);
  };
  if (wg == 1) sm90::named_arrive(1, 256);

  float r0, r1;
  sm90::mbar_wait(qbar, 0);
  sm90::mbar_wait(&full[0], 0);
  turn();
  sm90::wgmma_fence();
  issue_s(0);
  pass_turn(KT == 1);
  sm90::wgmma_wait<0>();
  sm90::fence_regs<64>(sc);
  softmax(0, r0, r1);
  pack();
  for (int t = 1; t < KT; ++t) {
    sm90::mbar_wait(&full[t % P1_STAGES], (t / P1_STAGES) & 1);
    sm90::fence_regs<64>(o);
    turn();
    sm90::wgmma_fence();
    issue_s(t);
    issue_pv(t - 1);
    pass_turn(t == KT - 1);
    sm90::wgmma_wait<1>();  // S(t) has landed; P(t - 1) V(t - 1) may run on
    sm90::fence_regs<64>(sc);
    softmax(t, r0, r1);
    sm90::wgmma_wait<0>();
    sm90::fence_regs<64>(o);
    release(t - 1);
#pragma unroll
    for (int dt = 0; dt < 16; ++dt) {
      o[4 * dt] *= r0;
      o[4 * dt + 1] *= r0;
      o[4 * dt + 2] *= r1;
      o[4 * dt + 3] *= r1;
    }
    pack();
  }
  sm90::fence_regs<64>(o);
  sm90::wgmma_fence();
  issue_pv(KT - 1);
  sm90::wgmma_wait<0>();
  sm90::fence_regs<64>(o);
  release(KT - 1);

  const float L0 = quad_sum(l0), L1 = quad_sum(l1);
  const float inv0 = 1.f / fmaxf(L0, 1e-30f), inv1 = 1.f / fmaxf(L1, 1e-30f);
  bf16* ob = out + (long long)b * o_b + (long long)h * o_h;
#pragma unroll
  for (int dt = 0; dt < 16; ++dt) {
    const int d = (dt / 8) * 64 + (dt % 8) * 8 + c2;
    *reinterpret_cast<uint32_t*>(ob + t0 * o_t + d) =
        pack2(o[4 * dt] * inv0, o[4 * dt + 1] * inv0);
    *reinterpret_cast<uint32_t*>(ob + t1 * o_t + d) =
        pack2(o[4 * dt + 2] * inv1, o[4 * dt + 3] * inv1);
  }
  if (lane % 4 == 0) {  // -inf for a row that saw no key
    lse[(long long)bh * Sq + t0] = m0 + log2f(L0);
    lse[(long long)bh * Sq + t1] = m1 + log2f(L1);
  }
}

// flags[b, i] = 1 where one of the 64 merge rows of local query block i is
// not 0; S is the local row count.
__global__ void __launch_bounds__(64)
merge_flags_kernel(const float* __restrict__ mm, int M, int S,
                   unsigned char* __restrict__ flags) {
  const int b = blockIdx.y, row = blockIdx.x * 64 + threadIdx.x;
  const float* r = mm + ((long long)b * S + row) * M;
  bool nz = false;
  for (int c = 0; c < M; ++c) nz |= r[c] != 0.f;
  nz = __syncthreads_or(nz);
  if (threadIdx.x == 0) flags[(long long)b * (S / 64) + blockIdx.x] = nz;
}

// Pass 2a's shared memory: the K tile, two Q stages, two stages of mm^T
// (MP rows of 64 queries, hi and lo), two of lse, the list of query blocks,
// the mbarriers.
struct MergedSmem {
  int MP, list_bytes;
  __host__ __device__ int q(int s) const { return TILE + s * TILE; }
  __host__ __device__ int mm(int s, int lo) const {
    return 3 * TILE + (2 * s + lo) * MP * 128;
  }
  __host__ __device__ int ls(int s) const {
    return 3 * TILE + 4 * MP * 128 + s * 256;
  }
  __host__ __device__ int list() const { return ls(2); }
  __host__ __device__ int bars() const { return list() + list_bytes; }
  __host__ __device__ int size() const { return bars() + 3 * 8 + 1024; }
};

// (x, y) -> bf16x2 hi and the bf16x2 of what hi leaves out.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(v);
  hi = *reinterpret_cast<const uint32_t*>(&v);
  lo = pack2(x - f.x, y - f.y);
}

template <int NT>
__device__ __forceinline__ void wgmma_rs_masks(float* d, const uint32_t* a,
                                               uint64_t db) {
  if constexpr (NT == 1) sm90::wgmma_rs_n8<0>(d, a, db, 1);
  else if constexpr (NT == 2) sm90::wgmma_rs_n16<0>(d, a, db, 1);
  else sm90::wgmma_rs_n32<0>(d, a, db, 1);
}

// blockIdx.x = key block * chunks + chunk: a key block's chunks are
// neighbours, so they share its K tile and the Q tiles in L2.
template <int NT>  // a chunk's masks padded to NT * 8: 8, 16 or 32
__global__ void __launch_bounds__(128)
merged_capture_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k, int H,
                           int rep, int S, int Sq, int q_off,
                           const unsigned char* __restrict__ key_valid,
                           const unsigned char* __restrict__ flags,
                           float alpha, const float* __restrict__ lse,
                           const float* __restrict__ mm, int M, int img_start,
                           int n_img, float* __restrict__ merged) {
  constexpr int MP = NT * 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  const MergedSmem L{MP, ((Sq / 64) * 2 + 15) / 16 * 16};
  uint64_t* kbar = reinterpret_cast<uint64_t*>(smem + L.bars());
  uint64_t* full = kbar + 1;
  int16_t* list = reinterpret_cast<int16_t*>(smem + L.list());
  __shared__ int n_list;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c2 = (lane % 4) * 2;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int chunks = (M + MP - 1) / MP;
  const int key0 = img_start + (blockIdx.x / chunks) * 64;  // first key
  // this chunk's masks [m0, m0 + w)
  const int m0 = (blockIdx.x % chunks) * MP, w = min(MP, M - m0);
  const int nqb = Sq / 64;  // local query blocks; block i is global i + qb0
  const int qb0 = q_off / 64;

  if (tid == 0) {
    sm90::mbar_init(kbar, 1);
    sm90::mbar_init(&full[0], 1);
    sm90::mbar_init(&full[1], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(kbar, TILE);
    for (int x = 0; x < 2; ++x)
      sm90::tma_load_4d(smem + x * BOX, &map_k, kbar, 64 * x, key0, h / rep,
                        b);
  }
  // warp 0: the local query blocks that see the block's keys (key0 % 64 ==
  // 0) and merge into a mask, in order
  if (warp == 0) {
    int n = 0;
    for (int base = max(0, key0 / 64 - qb0); base < nqb; base += 32) {
      const int i = base + lane;
      const bool f = i < nqb && flags[(long long)b * nqb + i];
      const unsigned ballot = __ballot_sync(0xffffffffu, f);
      if (f) list[n + __popc(ballot & ((1u << lane) - 1))] = (int16_t)i;
      n += __popc(ballot);
    }
    if (lane == 0) n_list = n;
  }
  // the mm^T rows past the chunk's w stay zero in both stages
  for (int i = tid; i < 4 * MP * 64; i += 128) {
    const int r = (i / 64) % MP;
    if (r >= w)
      reinterpret_cast<bf16*>(smem + L.mm(0, 0))[i] = __float2bfloat16(0.f);
  }
  __syncthreads();
  const int n = n_list;
  if (tid == 0 && n > 0) {
    sm90::mbar_expect_tx(&full[0], TILE);
    for (int x = 0; x < 2; ++x)
      sm90::tma_load_4d(smem + L.q(0) + x * BOX, &map_q, &full[0], 64 * x,
                        list[0] * 64, h, b);
  }

  // this thread's two keys: accumulator rows lane / 4 and + 8 of its warp's
  const int k0 = key0 + warp * 16 + lane / 4, k1 = k0 + 8;
  const bool ok0 = key_valid[(long long)b * S + k0] != 0;
  const bool ok1 = key_valid[(long long)b * S + k1] != 0;
  const float* lse_bh = lse + (long long)bh * Sq;
  const float* mm_b = mm + (long long)b * Sq * M;
  float acc[NT * 4];
#pragma unroll
  for (int i = 0; i < NT * 4; ++i) acc[i] = 0.f;
  float sc[32];
  sm90::mbar_wait(kbar, 0);

  for (int it = 0; it < n; ++it) {
    const int st = it & 1, q0 = list[it] * 64;
    // the chunk's mm^T of the 64 rows as bf16 hi + lo (row = mask, 64
    // queries of 128 bytes in the 128-byte swizzle), and their lse
    bf16* mhi = reinterpret_cast<bf16*>(smem + L.mm(st, 0));
    bf16* mlo = reinterpret_cast<bf16*>(smem + L.mm(st, 1));
    for (int i = tid; i < 64 * w; i += 128) {
      const int r = i / w, c = i % w;
      const float x = mm_b[(long long)(q0 + r) * M + m0 + c];
      const bf16 hi = __float2bfloat16(x);
      const int at = c * 64 + (((r >> 3) ^ (c & 7)) << 3) + (r & 7);
      mhi[at] = hi;
      mlo[at] = __float2bfloat16(x - __bfloat162float(hi));
    }
    float* ls = reinterpret_cast<float*>(smem + L.ls(st));
    if (tid < 64) ls[tid] = lse_bh[q0 + tid];
    sm90::fence_proxy_async();
    __syncthreads();
    // the other stage was read by the previous iteration's products, which
    // every thread has waited for
    if (tid == 0 && it + 1 < n) {
      sm90::mbar_expect_tx(&full[st ^ 1], TILE);
      for (int x = 0; x < 2; ++x)
        sm90::tma_load_4d(smem + L.q(st ^ 1) + x * BOX, &map_q, &full[st ^ 1],
                          64 * x, list[it + 1] * 64, h, b);
    }
    sm90::mbar_wait(&full[st], (it >> 1) & 1);

    // S^T = K Q^T (keys x queries), then p^T from the saved lse, the causal
    // compare against the global row qi.  A row
    // without a visible key has lse = -inf and every key masked
    scores64(sc, smem, smem + L.q(st));
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ql = 8 * j + c2 + e, qi = q0 + ql + q_off;
        const float l = ls[ql];
        sc[4 * j + e] = ok0 && k0 <= qi
            ? sm90::ex2(fmaf(sc[4 * j + e], alpha, -l)) : 0.f;
        sc[4 * j + 2 + e] = ok1 && k1 <= qi
            ? sm90::ex2(fmaf(sc[4 * j + 2 + e], alpha, -l)) : 0.f;
      }

    // acc (keys x masks) += P^T (keys x 16 queries) mm (16 queries x
    // masks) per k16 step: hi hi, lo hi, hi lo
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], ahi[kk][r],
               alo[kk][r]);
    sm90::fence_regs<NT * 4>(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bhi = sm90::desc_kmajor(smem + L.mm(st, 0) + kk * 32);
      const uint64_t blo = sm90::desc_kmajor(smem + L.mm(st, 1) + kk * 32);
      wgmma_rs_masks<NT>(acc, ahi[kk], bhi);
      wgmma_rs_masks<NT>(acc, alo[kk], bhi);
      wgmma_rs_masks<NT>(acc, ahi[kk], blo);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs<NT * 4>(acc);
  }

  // acc[4 n + e]: key k0 (e < 2) or k1, mask m0 + 8 n + c2 + (e & 1)
  float* out_bh = merged + ((long long)bh * M + m0) * n_img;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = (e < 2 ? k0 : k1) - img_start, m = 8 * nt + c2 + (e & 1);
      if (m < w && col < n_img)
        out_bh[(long long)m * n_img + col] = acc[4 * nt + e];
    }
}

// Pass 2b's shared memory: the Q tile, two K stages, two staged output
// tiles of 64 x 64 f32 (each two 64-row boxes of 32 columns in the 128-byte
// swizzle), the mbarriers.
constexpr int RAW_OUT = 3 * TILE;
constexpr int OUT_TILE = 64 * 64 * 4;
constexpr int RAW_BARS = RAW_OUT + 2 * OUT_TILE;
constexpr int RAW_SMEM = RAW_BARS + 3 * 8 + 1024;

// Element (r, c) of a staged output tile: box c / 32, row r of 128 bytes,
// 16-byte chunk (c % 32) / 4 at chunk ^ (r % 8).
__device__ __forceinline__ float* out_at(unsigned char* tile, int r, int c) {
  return reinterpret_cast<float*>(tile + (c / 32) * (OUT_TILE / 2) + r * 128 +
                                  ((((c % 32) / 4) ^ (r % 8)) << 4) +
                                  (c % 4) * 4);
}

template <bool TMA_OUT>  // else the threads copy the staged tiles out
__global__ void __launch_bounds__(128)
raw_capture_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_p, int H,
                        int rep, int S,
                        const unsigned char* __restrict__ key_valid,
                        float alpha, const float* __restrict__ lse,
                        int img_start, int n_img, float* __restrict__ probs) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + RAW_BARS);
  uint64_t* full = qbar + 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c2 = (lane % 4) * 2;
  const int q0 = blockIdx.x * 64, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int n_kt = (n_img + 63) / 64;
  // key tiles with a key at or below the block's last row: a prefix
  const int need = q0 < img_start ? 0 : min(n_kt, (q0 - img_start) / 64 + 1);
  const int prow = bh * S + q0;  // the block's first row of probs
  float* out_rows = probs + (long long)prow * n_img;

  if (tid == 0) {
    sm90::mbar_init(qbar, 1);
    sm90::mbar_init(&full[0], 1);
    sm90::mbar_init(&full[1], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  auto load_k = [&](int t) {
    sm90::mbar_expect_tx(&full[t & 1], TILE);
    for (int x = 0; x < 2; ++x)
      sm90::tma_load_4d(smem + TILE + (t & 1) * TILE + x * BOX, &map_k,
                        &full[t & 1], 64 * x, img_start + t * 64, h / rep, b);
  };
  if (tid == 0 && need > 0) {
    sm90::mbar_expect_tx(qbar, TILE);
    for (int x = 0; x < 2; ++x)
      sm90::tma_load_4d(smem + x * BOX, &map_q, qbar, 64 * x, q0, h, b);
    for (int t = 0; t < min(need, 2); ++t) load_k(t);
  }
  // a staged tile out: one thread stores it by TMA (clipped at n_img), or
  // the threads copy it, a row's 64 columns by 64 neighbouring threads
  auto store = [&](unsigned char* tile, int t) {
    if constexpr (TMA_OUT) {
      if (tid == 0) {
        sm90::tma_store_2d(&map_p, tile, t * 64, prow);
        sm90::tma_store_2d(&map_p, tile + OUT_TILE / 2, t * 64 + 32, prow);
        sm90::bulk_commit();
      }
    } else {
      for (int i = tid; i < 64 * 64; i += 128) {
        const int r = i / 64, c = i % 64;
        if (t * 64 + c < n_img)
          out_rows[(long long)r * n_img + t * 64 + c] = *out_at(tile, r, c);
      }
    }
  };

  const int rl0 = warp * 16 + lane / 4, rl1 = rl0 + 8;  // this thread's rows
  const int t0 = q0 + rl0, t1 = q0 + rl1;
  const float lse0 = lse[(long long)bh * S + t0];
  const float lse1 = lse[(long long)bh * S + t1];
  const unsigned char* valid = key_valid + (long long)b * S;
  float sc[32];
  if (need > 0) sm90::mbar_wait(qbar, 0);

  for (int t = 0; t < need; ++t) {
    const int key0 = img_start + t * 64;
    unsigned char* ot = smem + RAW_OUT + (t & 1) * OUT_TILE;
    sm90::mbar_wait(&full[t & 1], (t >> 1) & 1);
    scores64(sc, smem, smem + TILE + (t & 1) * TILE);
    // the store of tile t - 2 has read the staged tile
    if (TMA_OUT && tid == 0) sm90::bulk_wait_read<1>();
    __syncthreads();  // every warp's products have read the K stage
    if (tid == 0 && t + 2 < need) load_k(t + 2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t pair =
          *reinterpret_cast<const uint16_t*>(valid + key0 + 8 * j + c2);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + 8 * j + c2 + e;
        const bool ok = (pair >> (8 * e)) & 0xff;
        sc[4 * j + e] = ok && key <= t0
            ? sm90::ex2(fmaf(sc[4 * j + e], alpha, -lse0)) : 0.f;
        sc[4 * j + 2 + e] = ok && key <= t1
            ? sm90::ex2(fmaf(sc[4 * j + 2 + e], alpha, -lse1)) : 0.f;
      }
      *reinterpret_cast<float2*>(out_at(ot, rl0, 8 * j + c2)) =
          make_float2(sc[4 * j], sc[4 * j + 1]);
      *reinterpret_cast<float2*>(out_at(ot, rl1, 8 * j + c2)) =
          make_float2(sc[4 * j + 2], sc[4 * j + 3]);
    }
    if (TMA_OUT) sm90::fence_proxy_async();
    __syncthreads();
    store(ot, t);
  }
  // the tiles above the diagonal: zeros, stored from one zeroed tile
  if (need < n_kt) {
    unsigned char* zt = smem + RAW_OUT + (need & 1) * OUT_TILE;
    if (TMA_OUT && tid == 0) sm90::bulk_wait_read<1>();
    __syncthreads();
    for (int i = tid; i < OUT_TILE / 16; i += 128)
      reinterpret_cast<float4*>(zt)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (TMA_OUT) sm90::fence_proxy_async();
    __syncthreads();
    for (int t = need; t < n_kt; ++t) store(zt, t);
  }
  if (TMA_OUT && tid == 0) sm90::bulk_wait<0>();
}

// The tensor map of probs as (B * H * S) rows of n_img f32: boxes of 32
// columns x 64 rows in the 128-byte swizzle; stores past n_img are clipped.
// Rows must be 16-byte multiples: n_img % 4 == 0.
int make_probs_map(CUtensorMap* map, void* base, int n_img, long long rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 || n_img % 4)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)n_img, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)n_img * 4};
  const cuuint32_t box[2] = {32, 64};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, base, dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The operands both entry points share and their tensor maps.
struct Operands {
  const void *q, *k, *v;
  const unsigned char* valid;
  long long qs[3], ks[3], vs[3], os[3];
  int B, H, KV, S, Sq, q_off, img_start, n_img;
  bf16* out;
  float* lse;
  cudaStream_t st;
  // q (64-row boxes); k and v in 128-row boxes (pass 1); k in 64-row boxes
  // (the capture passes)
  CUtensorMap map_q, map_k128, map_v128, map_k;
  float alpha() const { return LOG2E / sqrtf((float)HD); }
};

// The contract, the tensor maps, then pass 1 (out and lse); returns the
// cudaError_t of the launch, cudaErrorInvalidValue for a refused shape.
int flash_forward(Operands& a, int head_dim) {
  const int n_img_pad = (a.n_img + BLOCK - 1) / BLOCK * BLOCK;
  if (head_dim != HD || a.B <= 0 || a.H <= 0 || a.KV <= 0 || a.H % a.KV ||
      a.S <= 0 || a.S % BLOCK || a.img_start < 0 || a.img_start % BLOCK ||
      a.n_img <= 0 || a.img_start + n_img_pad > a.S || a.Sq <= 0 ||
      a.Sq % BLOCK || a.q_off < 0 || a.q_off % BLOCK ||
      a.q_off + a.Sq > a.S || a.B * a.H > 65535 ||
      (long long)a.B * a.H * a.S > (1ll << 31) - 1 || a.os[0] % 2 ||
      a.os[1] % 2 || a.os[2] % 2 ||
      reinterpret_cast<uintptr_t>(a.valid) % 16)
    return (int)cudaErrorInvalidValue;
  // q holds Sq rows, k and v all S: the maps' row extents differ
  int e = make_heads_map(&a.map_q, a.q, a.qs[0], a.qs[1], a.qs[2], a.H,
                         a.B * a.H, a.Sq, HD);
  if (!e)
    e = make_heads_map(&a.map_k128, a.k, a.ks[0], a.ks[1], a.ks[2], a.KV,
                       a.B * a.KV, a.S, HD, 128);
  if (!e)
    e = make_heads_map(&a.map_v128, a.v, a.vs[0], a.vs[1], a.vs[2], a.KV,
                       a.B * a.KV, a.S, HD, 128);
  if (!e)
    e = make_heads_map(&a.map_k, a.k, a.ks[0], a.ks[1], a.ks[2], a.KV,
                       a.B * a.KV, a.S, HD);
  if (e) return e;
  static_assert(P1_SMEM <= SMEM_LIMIT, "shared memory");
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P1_SMEM);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_sm90_kernel<<<dim3(a.Sq / BLOCK, a.B * a.H), P1_THREADS,
                          P1_SMEM, a.st>>>(
      a.map_q, a.map_k128, a.map_v128, a.valid, a.H, a.H / a.KV, a.S, a.Sq,
      a.q_off, a.alpha(), a.out, a.os[0], a.os[1], a.os[2], a.lse);
  return (int)cudaGetLastError();
}

template <int NT>
int launch_merged(const Operands& a, const unsigned char* flags,
                  const float* mm, int M, float* merged) {
  auto kernel = merged_capture_sm90_kernel<NT>;
  const int smem =
      MergedSmem{NT * 8, ((a.Sq / 64) * 2 + 15) / 16 * 16}.size();
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int chunks = (M + NT * 8 - 1) / (NT * 8);
  kernel<<<dim3((a.n_img + 63) / 64 * chunks, a.B * a.H), 128, smem, a.st>>>(
      a.map_q, a.map_k, a.H, a.H / a.KV, a.S, a.Sq, a.q_off, a.valid, flags,
      a.alpha(), a.lse, mm, M, a.img_start, a.n_img, merged);
  return (int)cudaGetLastError();
}

template <bool TMA_OUT>
int launch_raw(const Operands& a, const CUtensorMap& map_p, float* probs) {
  auto kernel = raw_capture_sm90_kernel<TMA_OUT>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RAW_SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(a.S / 64, a.B * a.H), 128, RAW_SMEM, a.st>>>(
      a.map_q, a.map_k, map_p, a.H, a.H / a.KV, a.S, a.valid, a.alpha(),
      a.lse, a.img_start, a.n_img, probs);
  return (int)cudaGetLastError();
}

Operands operands(const void* q, long long q_b, long long q_h, long long q_t,
                  const void* k, long long k_b, long long k_h, long long k_t,
                  const void* v, long long v_b, long long v_h, long long v_t,
                  int B, int H, int KV, int S, int Sq, int q_off,
                  const void* key_valid, int img_start, int n_img, void* out,
                  long long o_b, long long o_h, long long o_t, void* lse,
                  void* stream) {
  return Operands{q, k, v, (const unsigned char*)key_valid, {q_b, q_h, q_t},
                  {k_b, k_h, k_t}, {v_b, v_h, v_t}, {o_b, o_h, o_t}, B, H, KV,
                  S, Sq, q_off, img_start, n_img, (bf16*)out, (float*)lse,
                  (cudaStream_t)stream, {}, {}, {}, {}};
}

}  // namespace

extern "C" int flmm_flash_capture(
    const void* q, long long q_b, long long q_h, long long q_t, const void* k,
    long long k_b, long long k_h, long long k_t, const void* v, long long v_b,
    long long v_h, long long v_t, int B, int H, int KV, int S, int Sq,
    int q_off, int head_dim, const void* key_valid, const void* mm, int M,
    int img_start, int n_img, void* out, long long o_b, long long o_h,
    long long o_t, void* lse, void* flags, void* merged, void* stream) {
  if (M < 0) return (int)cudaErrorInvalidValue;
  Operands a = operands(q, q_b, q_h, q_t, k, k_b, k_h, k_t, v, v_b, v_h, v_t,
                        B, H, KV, S, Sq, q_off, key_valid, img_start, n_img,
                        out, o_b, o_h, o_t, lse, stream);
  int e = flash_forward(a, head_dim);
  if (e || M == 0) return e;
  merge_flags_kernel<<<dim3(Sq / 64, B), 64, 0, a.st>>>(
      (const float*)mm, M, Sq, (unsigned char*)flags);
  e = (int)cudaGetLastError();
  if (e) return e;
  const unsigned char* f = (const unsigned char*)flags;
  const float* mmf = (const float*)mm;
  // above 32 masks, chunks of 32
  return M <= 8    ? launch_merged<1>(a, f, mmf, M, (float*)merged)
         : M <= 16 ? launch_merged<2>(a, f, mmf, M, (float*)merged)
                   : launch_merged<4>(a, f, mmf, M, (float*)merged);
}

extern "C" int flmm_flash_capture_raw(
    const void* q, long long q_b, long long q_h, long long q_t, const void* k,
    long long k_b, long long k_h, long long k_t, const void* v, long long v_b,
    long long v_h, long long v_t, int B, int H, int KV, int S, int head_dim,
    const void* key_valid, int img_start, int n_img, void* out, long long o_b,
    long long o_h, long long o_t, void* lse, void* probs, void* stream) {
  Operands a = operands(q, q_b, q_h, q_t, k, k_b, k_h, k_t, v, v_b, v_h, v_t,
                        B, H, KV, S, S, 0, key_valid, img_start, n_img, out,
                        o_b, o_h, o_t, lse, stream);
  const int e = flash_forward(a, head_dim);
  if (e) return e;
  CUtensorMap map_p = {};
  if (n_img % 4)  // rows TMA cannot address: the threads store
    return launch_raw<false>(a, map_p, (float*)probs);
  const int em = make_probs_map(&map_p, probs, n_img, (long long)B * H * S);
  return em ? em : launch_raw<true>(a, map_p, (float*)probs);
}
