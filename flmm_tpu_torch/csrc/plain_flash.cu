// Bias-free, non-causal attention for ViT towers: softmax(q k^T / sqrt(hd)) v
// over (G, S, hd) heads with any S and hd in {64, 72}, on Hopper's wgmma +
// TMA machinery.
//
// Replaces flmm_tpu/ops/sam_flash.py::plain_flash_attention (K7, the
// pallas_call at :185), and the first port's mma.sync kernel of this file
// (4 warps of 16 rows, 64-key K and V^T tiles staged synchronously: 0.256
// ms at the HPT shape, 3.8x F.scaled_dot_product_attention, chip_smoke.py
// phase 3 on an NVIDIA H100 80GB HBM3, 700.00 W).  The TPU kernel
// pads hd + 1 to 128 lanes, masks the padded keys through a -1e30 row of an
// augmented operand and reads the softmax denominator off a ones-column of
// v, all to feed whole MXU tiles from a one-shot softmax over the full key
// row.  None of that belongs on Hopper: this is K2's core
// (csrc/relpos_attention_sm90.cu) without the bias, with the running max and
// sum in registers.  Its own core, not a mode of the rel-pos one: that
// kernel is built around hd = 64 and the bias rows' shared memory, while
// this one needs neither bias nor tables but a second box per head row.
//
// What bounds it on an H100: at the HPT tower shape (G = 64, S = 1024, hd =
// 72) a layer is 19.3 GFLOP over 38 MB of operands, ~65x more tensor-core
// time than memory time, so operations bound it (0.020 ms); next come the
// exp2 of 67 M scores on the SFUs.  The (G, S, S) scores never exist.  The
// design:
//
// - a block owns 64 query rows of one (image, head) per consumer warpgroup
//   (two at hd 64, two blocks an SM; four at hd 72, one block an SM: the
//   four share each K / V tile) and one producer warp, which keeps TMA
//   loads of 64-key K and V tiles in flight through a ring of three
//   shared-memory stages with full / empty mbarriers;
// - S = Q K^T is wgmma m64n64k16 from the swizzled tiles; the online softmax
//   runs in base 2 on the f32 accumulators; p, rounded to bf16, is the A
//   operand of O += P V straight from registers, V read through wgmma's
//   transposed-B (MN-major) descriptor;
// - every operand is read through a 4D tensor map (column, token, head,
//   image) whose extents are the head's hd columns and S tokens, so a box
//   reads zeros past either: the query rows past S come in as zeros and are
//   not stored, the keys past S are masked by index in the last tile;
// - hd = 72 (SigLIP-SO400M: 1152 / 16 heads): a 128-byte-swizzled box
//   spans 64 bf16 columns, so a head row comes in as two boxes, columns 0-63
//   and 64-127, of which the second holds columns 64-71 and zeros (the next
//   head's q, k or v lies past the map's hd = 72 and is never read).  Q K^T
//   takes a fifth k16 step on the second boxes (columns 64-79, zeros past
//   72 on both sides).  A 128-byte MN-major V tile does not give wgmma an N
//   of 72, so O's columns 64-71 come from mma.sync m16n8k16: the same p
//   registers are its A fragments, ldmatrix.trans reads V's columns 64-71
//   off the second box as its B fragments;
// - numerics: q is read as it is and scale * log2(e) goes onto the f32
//   scores (the TPU wrapper rounds bf16(q * scale) first, :163: the same at
//   hd 64, where scale = 2^-3; at hd 72 one bf16 rounding of q apart);
//   scores, softmax and accumulation f32, p rounded to bf16 for P V, the row
//   sum of the unrounded p divides at the end.  (Trial builds on the card:
//   the TPU's sum of the rounded p, taken as P times a ones column by
//   mma.sync, and S(t + 1) issued with P(t) V(t) were both slower.)
//
// Layout: element (g, t, d) of q is at
//   (g / nh) * q_b + (g % nh) * q_h + t * q_t + d,
// k, v and the output likewise with their own strides, so the tower passes
// (B, H, S, hd) views of its (B, S, 3 * H * hd) qkv rows and gets
// (B, S, H, hd) memory back, with no transposed copies.  Input strides and
// base addresses are multiples of 8 elements (16 bytes), as TMA needs.
#include "sm90.cuh"

namespace {

constexpr int BKV = 64;
constexpr int TILE_BYTES = 64 * 128;  // one box: 64 rows of 64 bf16
constexpr int SMEM_LIMIT = 232448;
constexpr float LOG2E = 1.4426950408889634f;

// Boxes a head row takes, stages of the K / V ring and the byte offsets of
// the 1024-aligned dynamic shared memory: each consumer warpgroup's Q boxes,
// then per stage the K boxes and the V boxes, then the mbarriers.
template <int HD>
struct Cfg {
  static constexpr int BOXES = HD > 64 ? 2 : 1;
  // consumer warpgroups of 64 query rows and blocks an SM: hd 64 two and
  // two; hd 72, whose stages take twice the shared memory, four and one
  // (faster at the HPT shape in trial builds than three, or two in each of
  // two blocks: the four share each K / V tile)
  static constexpr int CONS = HD > 64 ? 4 : 2;
  static constexpr int MIN_BLOCKS = HD > 64 ? 1 : 2;
  static constexpr int THREADS = CONS * 128 + 32;  // + the producer warp
  static constexpr int STAGES = 3;
  static constexpr int Q_BYTES = CONS * BOXES * TILE_BYTES;
  static constexpr int STAGE_BYTES = 2 * BOXES * TILE_BYTES;
  static constexpr int BARS = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int SMEM = BARS + (2 * STAGES + 1) * 8 + 1024;
};

// Four 8 x 8 bf16 matrices, transposed: thread i gives the address of row
// i % 8 of matrix i / 8 and receives, of matrix m, column lane / 4 at rows
// (lane % 4) * 2 and + 1 in r[m] -- the B fragment of mma.sync m16n8k16
// for a row-major (key, column) tile.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sm90::smem_u32(p)));
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS,
                                  Cfg<HD>::MIN_BLOCKS)
plain_flash_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v, int nh,
                        int S, float alpha, bf16* __restrict__ out,
                        long long o_b, long long o_h, long long o_t) {
  using C = Cfg<HD>;
  constexpr bool TAIL = C::BOXES > 1;
  constexpr int CONS = C::CONS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BARS);
  uint64_t* empty = full + C::STAGES;
  uint64_t* qbar = empty + C::STAGES;
  const int tid = threadIdx.x, wg = tid / 128;
  const int g = blockIdx.y, q0 = blockIdx.x * 64 * CONS;
  const int img = g / nh, head = g % nh;
  const int KT = (S + BKV - 1) / BKV;

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONS * 4);  // one arrival a warp
    }
    sm90::mbar_init(qbar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONS) {
    // producer warp: one thread loads Q, then keeps the K / V ring full
    if (tid == CONS * 128) {
      sm90::mbar_expect_tx(qbar, C::Q_BYTES);
      for (int c = 0; c < CONS; ++c)
        for (int b = 0; b < C::BOXES; ++b)
          sm90::tma_load_4d(smem + (c * C::BOXES + b) * TILE_BYTES, &map_q,
                            qbar, 64 * b, q0 + 64 * c, head, img);
      for (int t = 0; t < KT; ++t) {
        const int s = t % C::STAGES;
        sm90::mbar_wait(&empty[s], ((t / C::STAGES) & 1) ^ 1);
        unsigned char* st = smem + C::Q_BYTES + s * C::STAGE_BYTES;
        sm90::mbar_expect_tx(&full[s], C::STAGE_BYTES);
        for (int b = 0; b < C::BOXES; ++b) {
          sm90::tma_load_4d(st + b * TILE_BYTES, &map_k, &full[s], 64 * b,
                            t * BKV, head, img);
          sm90::tma_load_4d(st + (C::BOXES + b) * TILE_BYTES, &map_v,
                            &full[s], 64 * b, t * BKV, head, img);
        }
      }
    }
    return;
  }

  // This thread's two rows (accumulator rows lane / 4 and lane / 4 + 8 of
  // its warp's 16) and its column pair (lane % 4) * 2 of every 8.
  const int warp = (tid % 128) / 32, lane = tid % 32, c2 = (lane % 4) * 2;
  const int row0 = wg * 64 + warp * 16 + lane / 4;
  const int t0 = q0 + row0, t1 = t0 + 8;
  const unsigned char* Qw = smem + wg * C::BOXES * TILE_BYTES;
  sm90::mbar_wait(qbar, 0);

  float o[32], ot[4];  // O's columns 0-63 (wgmma) and 64-71 (mma.sync)
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) ot[i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  float sc[BKV / 2];
  uint32_t pa[BKV / 16][4];

  // per key tile: S = Q K^T, the softmax, O += P V; the warpgroups
  // interleave, one's softmax beside another's products.  (Issuing S(t + 1)
  // with P(t) V(t), the softmax of S(t + 1) beside P(t) V(t), was slower in
  // a trial build, as for K2.)
  for (int t = 0; t < KT; ++t) {
    const int s = t % C::STAGES;
    sm90::mbar_wait(&full[s], (t / C::STAGES) & 1);
    const unsigned char* Ks = smem + C::Q_BYTES + s * C::STAGE_BYTES;
    const unsigned char* Vs = Ks + C::BOXES * TILE_BYTES;

    // S = Q K^T over the head's columns: 4 k16 steps on the first boxes,
    // one more on the second (columns 64-79, zeros past 72)
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_ss_n64<0>(sc, sm90::desc_kmajor(Qw + kk * 32),
                            sm90::desc_kmajor(Ks + kk * 32), kk > 0);
    if constexpr (TAIL)
      sm90::wgmma_ss_n64<0>(sc, sm90::desc_kmajor(Qw + TILE_BYTES),
                            sm90::desc_kmajor(Ks + TILE_BYTES), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs<BKV / 2>(sc);

    // keys past S masked (last tile only), the online softmax in base 2:
    // sc becomes p.  The max of the raw scores times alpha > 0 is the max
    // of the scaled ones.
    if ((t + 1) * BKV > S) {
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (t * BKV + 8 * j + c2 + e >= S)
            sc[4 * j + e] = sc[4 * j + 2 + e] = -CUDART_INF_F;
    }
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx0 = fmaxf(mx0, sc[4 * j + e]);
        mx1 = fmaxf(mx1, sc[4 * j + 2 + e]);
      }
    const float mn0 = fmaxf(m0, quad_max(mx0) * alpha);
    const float mn1 = fmaxf(m1, quad_max(mx1) * alpha);
    const float r0 = sm90::ex2(m0 - mn0), r1 = sm90::ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = sm90::ex2(fmaf(sc[4 * j + e], alpha, -mn0));
        sc[4 * j + 2 + e] = sm90::ex2(fmaf(sc[4 * j + 2 + e], alpha, -mn1));
        ps0 += sc[4 * j + e];
        ps1 += sc[4 * j + 2 + e];
      }
    l0 = l0 * r0 + ps0;  // this thread's columns; summed over the quad at
    l1 = l1 * r1 + ps1;  // the end
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      o[4 * dt] *= r0;
      o[4 * dt + 1] *= r0;
      o[4 * dt + 2] *= r1;
      o[4 * dt + 3] *= r1;
    }
    // p, rounded to bf16: the score accumulators of 16 keys are one A
    // fragment of P V
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      pa[kk][0] = pack2(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack2(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack2(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack2(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    if constexpr (TAIL) {
      // O's columns 64-71 += P V[:, 64:72] by mma.sync: V's second box
      // holds them as the 16-byte chunk 0 of each key row, at chunk (key %
      // 8) after the 128-byte swizzle; 32 keys an ldmatrix
      ot[0] *= r0;
      ot[1] *= r0;
      ot[2] *= r1;
      ot[3] *= r1;
      const unsigned char* Vt = Vs + TILE_BYTES;
#pragma unroll
      for (int half = 0; half < BKV / 32; ++half) {
        const int key = 32 * half + lane;
        uint32_t b[4];
        ldsm_x4_trans(b, Vt + key * 128 + ((key & 7) << 4));
        mma_16816(ot, pa[2 * half], b);
        mma_16816(ot, pa[2 * half + 1], b + 2);
      }
    }

    // O += P V over columns 0-63
    sm90::fence_regs<32>(o);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      sm90::wgmma_rs_n64<1>(o, pa[kk],
                            sm90::desc_mnmajor(Vs + kk * 2048, TILE_BYTES), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs<32>(o);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }

  const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
  bf16* ob = out + (long long)img * o_b + (long long)head * o_h;
  auto store = [&](int d, const float* acc) {
    if (t0 < S)
      *reinterpret_cast<uint32_t*>(ob + t0 * o_t + d) =
          pack2(acc[0] * inv0, acc[1] * inv0);
    if (t1 < S)
      *reinterpret_cast<uint32_t*>(ob + t1 * o_t + d) =
          pack2(acc[2] * inv1, acc[3] * inv1);
  };
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) store(dt * 8 + c2, o + 4 * dt);
  if constexpr (TAIL) store(64 + c2, ot);
}

template <int HD>
int launch(const CUtensorMap* maps, int nh, int G, int S, float alpha,
           bf16* out, long long o_b, long long o_h, long long o_t,
           cudaStream_t stream) {
  auto kernel = plain_flash_sm90_kernel<HD>;
  constexpr int smem = Cfg<HD>::SMEM;
  static_assert(smem <= SMEM_LIMIT, "shared memory");
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  constexpr int rows = 64 * Cfg<HD>::CONS;
  const dim3 grid((S + rows - 1) / rows, G);
  kernel<<<grid, Cfg<HD>::THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], nh, S, alpha, out, o_b, o_h, o_t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flmm_plain_flash(const void* q, long long q_b, long long q_h,
                                long long q_t, const void* k, long long k_b,
                                long long k_h, long long k_t, const void* v,
                                long long v_b, long long v_h, long long v_t,
                                int nh, int G, int S, int head_dim,
                                float scale, void* out, long long o_b,
                                long long o_h, long long o_t, void* stream) {
  if (G <= 0 || S <= 0 || nh <= 0 || G % nh || G > 65535 ||
      (head_dim != 64 && head_dim != 72) || o_b % 2 || o_h % 2 || o_t % 2)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3] = {};
  int e = make_heads_map(&maps[0], q, q_b, q_h, q_t, nh, G, S, head_dim);
  if (!e) e = make_heads_map(&maps[1], k, k_b, k_h, k_t, nh, G, S, head_dim);
  if (!e) e = make_heads_map(&maps[2], v, v_b, v_h, v_t, nh, G, S, head_dim);
  if (e) return e;
  const float alpha = scale * LOG2E;
  const cudaStream_t st = (cudaStream_t)stream;
  if (head_dim == 64)
    return launch<64>(maps, nh, G, S, alpha, (bf16*)out, o_b, o_h, o_t, st);
  return launch<72>(maps, nh, G, S, alpha, (bf16*)out, o_b, o_h, o_t, st);
}
