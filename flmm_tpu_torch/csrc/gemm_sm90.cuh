// The GEMM core of the port's transformer-block kernels on Hopper: one
// templated wgmma + TMA product with the epilogues the blocks need, and the
// LayerNorm row pass that feeds it.  Included by csrc/ln_gemm.cu (K3, K1's
// head, K10's two products) and csrc/block_tail.cu (K4, K1's tail, K8).
//
//   out = epi(A @ B),  A (M, K) bf16 row-major, B (K, N) bf16 row-major
//   epi: acc + bias                 rounded once to bf16 (qkv)
//        act(acc + bias)            rounded once to bf16 (the MLP hidden)
//        resid + (acc + bias)       resid bf16 or f32, out f32 or bf16
//
// What bounds it on an H100: at the block shapes (M = 2,304..32,768 rows,
// K and N = 768..5,120) a 128 x 128 tile does 128 FLOP per byte it loads,
// so with the operands in L2 the tensor cores bound it (989 TFLOP/s bf16).
// The design is Hopper's own: a block owns one 128 x 128 output tile, two
// blocks an SM (96 KB of stages and 90 registers a thread each), so one
// block's epilogue overlaps the other's products; one producer warp keeps
// TMA loads of 128 x 64 A slices and 64 x 128 B slices (two 64-column
// boxes, 128-byte swizzle) in flight through a ring of STAGES
// shared-memory stages with full / empty mbarriers; two consumer
// warpgroups of 64 rows each run wgmma.mma_async m64n128k16 straight from
// the swizzled tiles (A K-major, B MN-major through the descriptor's
// transpose bit), one group of four k16 steps kept in flight while the
// previous stage is released.  K is walked in one fixed order with no
// split-K and no atomics, so a result repeats bit for bit (K10's f32
// output relies on it).  The epilogue stages each warpgroup's f32 tile in
// the freed stage memory and writes whole rows with 8- or 16-byte stores,
// bias, activation and residual applied on the way.  Tiles of 128 x 128
// keep SigLIP's 2,304 rows at >= 144 blocks for every product of a block;
// in trial builds, tiles of 128 x 256 (m64n256k16, one block an SM) were
// no faster at any block shape, and four stages at one block an SM were
// slower.
//
// The LayerNorm is a row pass of its own (one warp a row: the mean, then
// the centred variance, as the JAX kernels compute them) that writes the
// normed rows in bf16 for the next product, zeroing rows whose row_valid
// byte is 0 (K1's geometric pad tokens).  The TPU kernels fused it into
// the product's prologue; a wgmma reads its operand from shared memory as
// TMA left it, so normalising on the way in would cost a register pass
// over every A tile of every N tile -- the pass costs one extra bf16 round
// trip of the (M, K) rows instead.
#pragma once

#include "sm90.cuh"

namespace {  // each source gets its own instantiations
namespace gemm {

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 3, CONSUMERS = 2;
constexpr int THREADS = CONSUMERS * 128 + 32;  // + the producer warp
constexpr int A_BYTES = BM * BK * 2, B_BYTES = BK * BN * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int EPI_LD = BN + 4;  // f32 staging row of the epilogue
constexpr size_t SMEM = (size_t)STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
static_assert(CONSUMERS * 64 * EPI_LD * 4 <= STAGES * STAGE_BYTES,
              "the epilogue tiles fit in the stage memory");

enum Resid { RESID_NONE = 0, RESID_BF16 = 1, RESID_F32 = 2 };
constexpr int NO_ACT = -1;

// 4 consecutive values -> f32, from bf16 (8 bytes) or f32 (16 bytes).
__device__ __forceinline__ void load4(const bf16* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

template <int ACT, int RESID, bool OUT_F32>
__global__ void __launch_bounds__(THREADS, 2)
gemm_kernel(const __grid_constant__ CUtensorMap map_a,
            const __grid_constant__ CUtensorMap map_b, int M, int N, int K,
            const bf16* __restrict__ bias, const void* __restrict__ resid,
            void* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KT = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], CONSUMERS * 4);  // one arrival a warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer warp: one thread keeps the ring full
    if (tid == CONSUMERS * 128) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        sm90::mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        unsigned char* st = smem + s * STAGE_BYTES;
        sm90::mbar_expect_tx(&full[s], STAGE_BYTES);
        sm90::tma_load_2d(st, &map_a, &full[s], kt * BK, m0);
        sm90::tma_load_2d(st + A_BYTES, &map_b, &full[s], n0, kt * BK);
        sm90::tma_load_2d(st + A_BYTES + B_BYTES / 2, &map_b, &full[s],
                          n0 + 64, kt * BK);
      }
    }
    return;
  }

  const int lane = tid % 32, warp = (tid % 128) / 32;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES;
    sm90::mbar_wait(&full[s], (kt / STAGES) & 1);
    const unsigned char* st = smem + s * STAGE_BYTES;
    sm90::fence_regs<BN / 2>(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      sm90::wgmma_ss_n128<1>(
          acc, sm90::desc_kmajor(st + wg * (64 * 128) + kk * 32),
          sm90::desc_mnmajor(st + A_BYTES + kk * 2048, B_BYTES / 2),
          kt > 0 || kk > 0);
    sm90::wgmma_commit();
    sm90::fence_regs<BN / 2>(acc);
    // the previous stage's products are done: release it
    sm90::wgmma_wait<1>();
    sm90::fence_regs<BN / 2>(acc);
    __syncwarp();
    if (kt > 0 && lane == 0) sm90::mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs<BN / 2>(acc);

  // epilogue: both warpgroups are past their last product, so the stage
  // memory is free; each stages its 64 x 128 f32 tile there
  sm90::named_sync(1, CONSUMERS * 128);
  float* tile = reinterpret_cast<float*>(smem) + wg * 64 * EPI_LD;
  const int r0 = warp * 16 + lane / 4, c2 = (lane % 4) * 2;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    *reinterpret_cast<float2*>(tile + r0 * EPI_LD + 8 * j + c2) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(tile + (r0 + 8) * EPI_LD + 8 * j + c2) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  sm90::named_sync(2 + wg, 128);
  const int col = n0 + lane * 4;
  if (col >= N) return;  // N % 8 == 0: a live column has 3 more after it
  float bv[4];
  load4(bias + col, bv);
  for (int r = warp; r < 64; r += 4) {
    const int gr = m0 + wg * 64 + r;
    if (gr >= M) break;
    float v[4];
    load4(tile + r * EPI_LD + lane * 4, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] += bv[i];
      if constexpr (ACT != NO_ACT) v[i] = activate<ACT>(v[i]);
    }
    const size_t off = (size_t)gr * N + col;
    if constexpr (RESID != RESID_NONE) {
      float rv[4];
      if constexpr (RESID == RESID_BF16)
        load4(static_cast<const bf16*>(resid) + off, rv);
      else
        load4(static_cast<const float*>(resid) + off, rv);
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = rv[i] + v[i];
    }
    if constexpr (OUT_F32) {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + off) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
      uint2 u;
      u.x = pack2(v[0], v[1]);
      u.y = pack2(v[2], v[3]);
      *reinterpret_cast<uint2*>(static_cast<bf16*>(out) + off) = u;
    }
  }
}

// out = epi(A (M, K) @ B (K, N)); every pointer 16-byte aligned, N and K
// multiples of 8.  Returns 0 or a cudaError_t.
template <int ACT, int RESID, bool OUT_F32>
int launch_gemm(const void* A, int M, int K, const void* B, int N,
                const void* bias, const void* resid, void* out,
                cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8 ||
      (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  int e = make_tile_map(&map_a, A, K, M, K, BM);
  if (e) return e;
  e = make_tile_map(&map_b, B, N, K, N, BK);
  if (e) return e;
  auto kernel = gemm_kernel<ACT, RESID, OUT_F32>;
  const cudaError_t ce = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (ce != cudaSuccess) return (int)ce;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, THREADS, SMEM, stream>>>(
      map_a, map_b, M, N, K, static_cast<const bf16*>(bias), resid, out);
  return (int)cudaGetLastError();
}

// The hidden product with the activation chosen at run time
// (flmm_tpu_torch.ops.fused_block.ACTS).
inline int launch_gemm_act(int act, const void* A, int M, int K,
                           const void* B, int N, const void* bias, void* out,
                           cudaStream_t s) {
  switch (act) {
    case ACT_GELU:
      return launch_gemm<ACT_GELU, RESID_NONE, false>(A, M, K, B, N, bias,
                                                      nullptr, out, s);
    case ACT_GELU_TANH:
      return launch_gemm<ACT_GELU_TANH, RESID_NONE, false>(A, M, K, B, N,
                                                           bias, nullptr,
                                                           out, s);
    case ACT_QUICK_GELU:
      return launch_gemm<ACT_QUICK_GELU, RESID_NONE, false>(A, M, K, B, N,
                                                            bias, nullptr,
                                                            out, s);
    case ACT_RELU:
      return launch_gemm<ACT_RELU, RESID_NONE, false>(A, M, K, B, N, bias,
                                                      nullptr, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---- LayerNorm row pass ----------------------------------------------------

constexpr int LN_ROWS = 8;  // rows (warps) a block

__device__ __forceinline__ void load8(const bf16* p, float* f) {
  unpack8(*reinterpret_cast<const uint4*>(p), f);
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  load4(p, f);
  load4(p + 4, f + 4);
}

// y (M, C) bf16 = LN(x) * w + b, a row zero where row_valid[row] == 0.
template <typename T>
__global__ void __launch_bounds__(LN_ROWS * 32)
ln_rows_kernel(const T* __restrict__ x, int M, int C, float eps,
               const bf16* __restrict__ w, const bf16* __restrict__ b,
               const unsigned char* __restrict__ row_valid,
               bf16* __restrict__ y) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * LN_ROWS + threadIdx.x / 32;
  if (row >= M) return;
  const T* xr = x + (size_t)row * C;
  bf16* yr = y + (size_t)row * C;
  if (row_valid != nullptr && !row_valid[row]) {
    for (int c = lane * 8; c < C; c += 256)
      *reinterpret_cast<uint4*>(yr + c) = make_uint4(0, 0, 0, 0);
    return;
  }
  float f[8], s = 0.f;
  for (int c = lane * 8; c < C; c += 256) {
    load8(xr + c, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += f[i];
  }
  const float mu = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane * 8; c < C; c += 256) {
    load8(xr + c, f);
#pragma unroll
    for (int i = 0; i < 8; ++i) v += (f[i] - mu) * (f[i] - mu);
  }
  const float rs = rsqrtf(warp_sum(v) / C + eps);
  for (int c = lane * 8; c < C; c += 256) {
    float wv[8], bv[8];
    load8(xr + c, f);
    load8(w + c, wv);
    load8(b + c, bv);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = (f[i] - mu) * rs * wv[i] + bv[i];
    *reinterpret_cast<uint4*>(yr + c) = pack8(f);
  }
}

template <typename T>
int launch_ln_rows(const T* x, int M, int C, float eps, const void* w,
                   const void* b, const void* row_valid, void* y,
                   cudaStream_t s) {
  if (M <= 0 || C <= 0 || C % 8) return (int)cudaErrorInvalidValue;
  ln_rows_kernel<T><<<(M + LN_ROWS - 1) / LN_ROWS, LN_ROWS * 32, 0, s>>>(
      x, M, C, eps, static_cast<const bf16*>(w), static_cast<const bf16*>(b),
      static_cast<const unsigned char*>(row_valid), static_cast<bf16*>(y));
  return (int)cudaGetLastError();
}

}  // namespace gemm
}  // namespace
