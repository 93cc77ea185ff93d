// H.264 in-loop deblocking filter (§8.7) from packed edge maps, as an
// anti-diagonal wavefront of one launch per diagonal and one CTA per
// macroblock.  Hand-written for Hopper (sm_90a).
//
// Replaces: x264vfw_tpu/ops/pallas/deblock.py :: deblock_apply (Pallas body
// _deblock_kernel), and computes what the JAX hot path computes with
// x264vfw_tpu/ops/deblock.py :: deblock_apply_wavefront.
//
// Contract: y (H, W) and u, v (H/2, W/2) int32, filtered in place (the
// wrapper passes copies); mapsV (H, 4mbw), mapsH (4mbh, W), mapsVc
// (H/2, 2mbw), mapsHc (2mbh, W/2) int32, one packed word per edge line:
// bits 0-2 bS, 3-7 tc0, 8-15 alpha, 16-20 beta.  The result equals §8.7 in
// MB raster order: per MB the vertical edges left to right, then the
// horizontal edges top to bottom; luma tc = tc0 + (ap < beta) + (aq <
// beta), chroma tc = tc0 + 1; bS = 4 takes the strong filter; bS = 0 (every
// frame border) leaves the edge as it is.
//
// Order: MB (r, c) reads and writes the 3 luma (1 chroma) pixel columns of
// (r, c-1) next to its left edge and the rows of (r-1, c) above its top
// edge, which (r-1, c+1)'s left edge wrote before it.  MBs on one
// diagonal d = 2r + c touch disjoint pixels and depend only on lower
// diagonals, so launching d = 0 .. 2(mbh-1) + mbw - 1 in turn on one
// stream gives the raster order's result.
//
// What bounds it on an H100: the dependency chain, not the card.  The
// bytes the function must move (the planes read and written once as int32,
// the maps read once: ~30 MB at 1080p) take ~9 us at 3.35 TB/s, and the
// arithmetic is a few dozen integer operations per filtered pixel; but 254
// diagonals at 1080p must run one after another, each holding at most 68
// MBs, so the launches' latency sets the time.
//
// What the design does about it: each CTA keeps its MB's luma tile with
// a 4-pixel halo above and left (20 x 20) and the two chroma tiles with a
// 2-pixel halo (10 x 10) in shared memory, filters every edge there (one
// thread per line: 16 luma and 2 x 8 chroma lines per edge), and writes
// back only the pixels a filter can change: the MB and the 3 (chroma 1)
// pixels beyond its left and top edges.  The corner of the halo is never
// written, so two MBs of one diagonal never store to the same pixel.  A
// persistent kernel with a per-row progress flag would remove the launch
// chain; that is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

struct Edge {
  int bs, tc0, alpha, beta;
};

__device__ __forceinline__ Edge unpack(int32_t m) {
  return {m & 7, (m >> 3) & 31, (m >> 8) & 255, (m >> 16) & 31};
}

__device__ __forceinline__ int clip3(int lo, int hi, int x) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// one luma line across an edge: p[0..3] = p3..p0, q[0..3] = q0..q3, each
// a pointer into shared memory stepping `st` elements away from the edge
__device__ void luma_line(int32_t* e, int st, int32_t m) {
  const Edge k = unpack(m);
  const int p3 = e[-4 * st], p2 = e[-3 * st], p1 = e[-2 * st], p0 = e[-st];
  const int q0 = e[0], q1 = e[st], q2 = e[2 * st], q3 = e[3 * st];
  if (!(k.bs > 0 && abs(p0 - q0) < k.alpha && abs(p1 - p0) < k.beta &&
        abs(q1 - q0) < k.beta)) {
    return;
  }
  const bool ap = abs(p2 - p0) < k.beta;
  const bool aq = abs(q2 - q0) < k.beta;
  if (k.bs == 4) {
    const bool strong = abs(p0 - q0) < ((k.alpha >> 2) + 2);
    if (ap && strong) {
      e[-st] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
      e[-2 * st] = (p2 + p1 + p0 + q0 + 2) >> 2;
      e[-3 * st] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
    } else {
      e[-st] = (2 * p1 + p0 + q1 + 2) >> 2;
    }
    if (aq && strong) {
      e[0] = (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3;
      e[st] = (p0 + q0 + q1 + q2 + 2) >> 2;
      e[2 * st] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
    } else {
      e[0] = (2 * q1 + q0 + p1 + 2) >> 2;
    }
    return;
  }
  const int tc = k.tc0 + (int)ap + (int)aq;
  const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
  e[-st] = clip3(0, 255, p0 + delta);
  e[0] = clip3(0, 255, q0 - delta);
  if (ap) {
    e[-2 * st] = p1 + clip3(-k.tc0, k.tc0,
                            (p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1);
  }
  if (aq) {
    e[st] = q1 + clip3(-k.tc0, k.tc0,
                       (q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1);
  }
}

__device__ void chroma_line(int32_t* e, int st, int32_t m) {
  const Edge k = unpack(m);
  const int p1 = e[-2 * st], p0 = e[-st], q0 = e[0], q1 = e[st];
  if (!(k.bs > 0 && abs(p0 - q0) < k.alpha && abs(p1 - p0) < k.beta &&
        abs(q1 - q0) < k.beta)) {
    return;
  }
  if (k.bs == 4) {
    e[-st] = (2 * p1 + p0 + q1 + 2) >> 2;
    e[0] = (2 * q1 + q0 + p1 + 2) >> 2;
    return;
  }
  const int tc = k.tc0 + 1;
  const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
  e[-st] = clip3(0, 255, p0 + delta);
  e[0] = clip3(0, 255, q0 - delta);
}

__global__ void __launch_bounds__(kThreads)
deblock_diagonal_kernel(int32_t* __restrict__ y, int32_t* __restrict__ u,
                        int32_t* __restrict__ v,
                        const int32_t* __restrict__ mapsV,
                        const int32_t* __restrict__ mapsH,
                        const int32_t* __restrict__ mapsVc,
                        const int32_t* __restrict__ mapsHc, int H, int W,
                        int d, int r0) {
  __shared__ int32_t ty[20][21];
  __shared__ int32_t tc[2][10][11];
  const int r = r0 + blockIdx.x;
  const int c = d - 2 * r;
  const int mbw = W / 16;
  const int Wc = W / 2;
  const int t = threadIdx.x;
  int32_t* cpl[2] = {u, v};

  // ---- load: MB + 4-pixel halo above/left (chroma 2); outside the frame
  // the halo is 0 and its edges carry bS = 0 ----
  for (int i = t; i < 400; i += kThreads) {
    const int a = i / 20, b = i - a * 20;
    const int gy = 16 * r - 4 + a, gx = 16 * c - 4 + b;
    ty[a][b] = (gy >= 0 && gx >= 0) ? y[(size_t)gy * W + gx] : 0;
  }
  for (int i = t; i < 200; i += kThreads) {
    const int p = i / 100, ab = i - p * 100;
    const int a = ab / 10, b = ab - a * 10;
    const int gy = 8 * r - 2 + a, gx = 8 * c - 2 + b;
    tc[p][a][b] = (gy >= 0 && gx >= 0) ? cpl[p][(size_t)gy * Wc + gx] : 0;
  }
  __syncthreads();

  // ---- vertical edges, left to right: one thread per line ----
  if (t < 16) {
    const int32_t* mv = mapsV + (size_t)(16 * r + t) * (4 * mbw) + 4 * c;
    for (int e = 0; e < 4; ++e) luma_line(&ty[4 + t][4 + 4 * e], 1, mv[e]);
  } else {
    const int p = (t - 16) >> 3, row = (t - 16) & 7;
    const int32_t* mv = mapsVc + (size_t)(8 * r + row) * (2 * mbw) + 2 * c;
    for (int e = 0; e < 2; ++e) {
      chroma_line(&tc[p][2 + row][2 + 4 * e], 1, mv[e]);
    }
  }
  __syncthreads();

  // ---- horizontal edges, top to bottom: one thread per column ----
  if (t < 16) {
    for (int f = 0; f < 4; ++f) {
      luma_line(&ty[4 + 4 * f][4 + t], 21,
                mapsH[(size_t)(4 * r + f) * W + 16 * c + t]);
    }
  } else {
    const int p = (t - 16) >> 3, col = (t - 16) & 7;
    for (int f = 0; f < 2; ++f) {
      chroma_line(&tc[p][2 + 4 * f][2 + col], 11,
                  mapsHc[(size_t)(2 * r + f) * Wc + 8 * c + col]);
    }
  }
  __syncthreads();

  // ---- write back the MB and the pixels beyond its left and top edges
  // (3 luma, 1 chroma) ----
  for (int i = t; i < 16 * 19; i += kThreads) {
    const int a = i / 19, b = i - a * 19 + 1;        // rows of the MB
    const int gx = 16 * c - 4 + b;
    if (gx >= 0) y[(size_t)(16 * r + a) * W + gx] = ty[4 + a][b];
  }
  if (r > 0) {
    for (int i = t; i < 3 * 16; i += kThreads) {
      const int a = i / 16 + 1, b = i % 16;          // rows above the MB
      y[(size_t)(16 * r - 4 + a) * W + 16 * c + b] = ty[a][4 + b];
    }
  }
  for (int i = t; i < 2 * 8 * 9; i += kThreads) {
    const int p = i / 72, ab = i - p * 72;
    const int a = ab / 9, b = ab - a * 9 + 1;
    const int gx = 8 * c - 2 + b;
    if (gx >= 0) cpl[p][(size_t)(8 * r + a) * Wc + gx] = tc[p][2 + a][b];
  }
  if (r > 0 && t < 16) {
    const int p = t >> 3, b = t & 7;
    cpl[p][(size_t)(8 * r - 1) * Wc + 8 * c + b] = tc[p][1][2 + b];
  }
}

}  // namespace

// Plain C entry for ctypes: filters y, u, v in place, one launch per
// diagonal on `stream`.  Every pointer is a device pointer.  Returns the
// first launch error, else cudaGetLastError() after the last launch.
extern "C" int x264t_deblock_apply(void* y, void* u, void* v, int H, int W,
                                   const void* mapsV, const void* mapsH,
                                   const void* mapsVc, const void* mapsHc,
                                   void* stream) {
  if (H < 16 || W < 16 || H % 16 || W % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const int mbh = H / 16, mbw = W / 16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int d = 0; d < 2 * (mbh - 1) + mbw; ++d) {
    const int r0 = d - mbw + 2 > 0 ? (d - mbw + 2) / 2 : 0;
    const int r1 = min(mbh - 1, d / 2);
    deblock_diagonal_kernel<<<r1 - r0 + 1, kThreads, 0, st>>>(
        static_cast<int32_t*>(y), static_cast<int32_t*>(u),
        static_cast<int32_t*>(v), static_cast<const int32_t*>(mapsV),
        static_cast<const int32_t*>(mapsH),
        static_cast<const int32_t*>(mapsVc),
        static_cast<const int32_t*>(mapsHc), H, W, d, r0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
