// Window-major <-> spatial relayout of the SAM encoder's token grid.
//
// Replaces flmm_tpu/ops/boundary.py::dewindowize (K11a, the pallas_call at
// :59) and ::windowize (K11b, :85):
//
//   windowize:   (B, H, W, C) -> (B * nwy * nwx, ws * ws, C), the grid
//                zero-padded up to whole ws x ws windows (Hp x Wp);
//   dewindowize: (B * nwy * nwx, ws * ws, C) -> (B, H, W, C), cropped.
//
// The TPU kernels DMA one window row per step of a sequential grid and swap
// (ws, ws * C) tiles in registers, and their wrappers add a full jnp.pad
// copy before windowize and a crop after dewindowize.  On an H100 this is a
// pure copy bound by bytes (no operation at all): every thread moves one
// 16-byte vector of a token's C row and computes both addresses itself, a
// token's row (2048 B at C = 1024 in bf16) is read and written by
// neighbouring threads, windowize writes the zero pad slots itself (no
// padded intermediate) and dewindowize reads only the valid tokens.  The
// kernels see bytes, so any element type whose token row is a multiple of
// 16 bytes works (bf16 and f32 are bound).
//
// vpt is the number of 16-byte vectors per token (C * itemsize / 16).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

struct Geom {
  int B, H, W, Hp, Wp, ws, vpt;
};

// Vector v of the window-major tensor <-> its spatial source; false for a
// pad slot.
__device__ __forceinline__ bool spatial_of_window(const Geom& g, long long tok,
                                                  long long& spatial_tok) {
  const int T = g.ws * g.ws, nwx = g.Wp / g.ws, nwy = g.Hp / g.ws;
  const int t = (int)(tok % T);
  const long long w = tok / T;
  const int wx = (int)(w % nwx), wy = (int)((w / nwx) % nwy);
  const long long b = w / ((long long)nwx * nwy);
  const int y = wy * g.ws + t / g.ws, x = wx * g.ws + t % g.ws;
  spatial_tok = (b * g.H + y) * g.W + x;
  return y < g.H && x < g.W;
}

__global__ void __launch_bounds__(THREADS)
windowize_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, Geom g,
                 long long total) {
  const long long v = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (v >= total) return;
  long long src;
  uint4 val = make_uint4(0u, 0u, 0u, 0u);
  if (spatial_of_window(g, v / g.vpt, src)) val = x[src * g.vpt + v % g.vpt];
  out[v] = val;
}

__global__ void __launch_bounds__(THREADS)
dewindowize_kernel(const uint4* __restrict__ xw, uint4* __restrict__ out,
                   Geom g, long long total) {
  const long long v = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (v >= total) return;
  const long long tok = v / g.vpt;  // (b, y, x)
  const int x = (int)(tok % g.W), y = (int)((tok / g.W) % g.H);
  const long long b = tok / ((long long)g.W * g.H);
  const int nwx = g.Wp / g.ws, nwy = g.Hp / g.ws;
  const long long w = (b * nwy + y / g.ws) * nwx + x / g.ws;
  const int t = (y % g.ws) * g.ws + x % g.ws;
  out[v] = xw[(w * g.ws * g.ws + t) * g.vpt + v % g.vpt];
}

bool bad_geometry(const Geom& g) {
  return g.B <= 0 || g.H <= 0 || g.W <= 0 || g.ws <= 0 || g.vpt <= 0 ||
         g.Hp < g.H || g.Wp < g.W || g.Hp % g.ws || g.Wp % g.ws;
}

}  // namespace

extern "C" int flmm_windowize(const void* x, void* out, int B, int H, int W,
                              int Hp, int Wp, int ws, int vpt, void* stream) {
  const Geom g{B, H, W, Hp, Wp, ws, vpt};
  if (bad_geometry(g)) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * Hp * Wp * vpt;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  windowize_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)x, (uint4*)out, g, total);
  return (int)cudaGetLastError();
}

extern "C" int flmm_dewindowize(const void* xw, void* out, int B, int H, int W,
                                int Hp, int Wp, int ws, int vpt,
                                void* stream) {
  const Geom g{B, H, W, Hp, Wp, ws, vpt};
  if (bad_geometry(g)) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * H * W * vpt;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dewindowize_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)xw, (uint4*)out, g, total);
  return (int)cudaGetLastError();
}
