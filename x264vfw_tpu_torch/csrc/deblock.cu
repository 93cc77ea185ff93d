// H.264 in-loop deblocking filter (§8.7) from packed edge maps, as one
// persistent launch per frame: each CTA owns a macroblock row and walks it
// left to right, one MB behind the row above, through progress counters.
// Hand-written for Hopper (sm_90a).
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
// frame border) leaves the edge as it is.  `progress` is int32 scratch of
// 32 * (mbh + 1) words, zeroed by the caller before the launch.
//
// Order: MB (r, c) reads and writes the 3 luma (1 chroma) pixel columns of
// (r, c-1) next to its left edge and the rows of (r-1, c) above its top
// edge, which (r-1, c+1)'s left edge wrote before it.  Its vertical edges
// touch only rows of MB row r.  So the horizontal edges of (r, c) may run
// once row r-1 has filtered MB c and the vertical edges of c + 1, and its
// vertical edges once (r, c-1) is done: each row trails the row above by
// one MB, and the dependency chain is mbw + mbh - 1 MB steps long (187 at
// 1080p) where the Pallas kernel's anti-diagonal order d = 2r + c took
// 2(mbh-1) + mbw (254).  The result is the raster order's.
//
// What bounds it on an H100: the dependency chain, not the card.  The
// bytes the function must move (the planes read and written once as int32,
// the maps read once: ~30 MB at 1080p) take ~9 us at 3.35 TB/s, and the
// arithmetic is a few dozen integer operations per filtered pixel, but the
// MB steps must run one after another.  A launch per diagonal cost ~9.3 us
// a step; here a step between rows costs a flag's trip through L2, a read
// of the 4 rows above from L2 and one MB's filtering by a single warp.
//
// What the design does about it:
//   * one launch; each CTA takes its row from an atomic ticket, not from
//     blockIdx, so a CTA only ever waits on a row that an already running
//     CTA holds, whatever order the scheduler starts CTAs in;
//   * three warps per CTA: warp 0 filters the 16 luma lines of an edge,
//     warp 1 the 2 x 8 chroma lines (so luma and chroma run side by side),
//     and warp 2 only publishes progress;
//   * per step c the CTA holds MB c (A) and MB c + 1 (B) in two shared
//     tiles (20 x 20 luma with a 4-pixel halo above and left, 2 x 10 x 10
//     chroma with a 2-pixel halo).  It filters A's inner vertical edges,
//     waits for row r-1, reads the rows above A, filters A's horizontal
//     edges, copies A's right columns into B's left halo and filters B's
//     left edge, and then A is final:
//     its MB and the 3 (chroma 1) rows above it are stored (the last 3
//     luma, 1 chroma columns from B's halo).  The halo's corner is never
//     stored.  B's pixels and maps are fetched into registers a step
//     ahead, so the only loads that wait are the rows above;
//   * progress[32 (r + 1)] counts the MBs row r has stored, one counter
//     per 128-byte line.  After the stores a CTA barrier (0) orders them
//     before warp 2's st.release.gpu of c + 1 (release is cumulative over
//     the barrier); the release's fence then runs while warps 0-1 go on
//     with the next MB on barrier 1.  A waiting CTA spins in one thread
//     on ld.acquire.gpu, then syncs;
//   * pixels that another CTA wrote (the rows above the MB) are read after
//     the acquire with __ldcg, which reads L2, the point of coherence, and
//     never a stale L1 line.  Every other plane read uses __ldcg too; the
//     maps, which nothing writes, __ldg.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWorkers = 64;   // warp 0 luma, warp 1 chroma
constexpr int kThreads = 96;   // + warp 2, which publishes progress
constexpr int kLS = 21;        // luma tile row: 4 halo + 16 + 1 pad
constexpr int kCS = 11;        // chroma tile row: 2 halo + 8 + 1 pad

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

constexpr int kFlagStride = 32;   // ints per progress counter (128 B)

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// barrier of the two filtering warps only (the publisher keeps to
// barrier 0)
__device__ __forceinline__ void sync_workers() {
  asm volatile("bar.sync 1, 64;" ::: "memory");
}

// What one thread fetches of an MB before it is filtered: one int4 of the
// luma MB, one int4 of the chroma MBs (threads 0-31), and the maps of the
// lines it filters (lanes 0-15 of each warp).
struct Fetch {
  int4 py, pc;
  int32_t mv[4];   // vertical edges of its line (chroma: 2)
  int32_t mh[4];   // horizontal edges of its column (chroma: 2)
};

struct Planes {
  int32_t* y;
  int32_t* c[2];
  const int32_t* mapsV;
  const int32_t* mapsH;
  const int32_t* mapsVc;
  const int32_t* mapsHc;
  int W;
};

__device__ __forceinline__ void fetch(Fetch& f, const Planes& P, int r, int c,
                                      int t) {
  const int W = P.W, mbw = W / 16, Wc = W / 2;
  const int lane = t & 31;
  f.py = __ldcg(reinterpret_cast<const int4*>(
      P.y + (size_t)(16 * r + (t >> 2)) * W + 16 * c + 4 * (t & 3)));
  if (t < 32) {
    const int p = t >> 4, a = (t & 15) >> 1, q = t & 1;
    f.pc = __ldcg(reinterpret_cast<const int4*>(
        P.c[p] + (size_t)(8 * r + a) * Wc + 8 * c + 4 * q));
  }
  if (t < 16) {
    const int4 m = __ldg(reinterpret_cast<const int4*>(
        P.mapsV + (size_t)(16 * r + t) * (4 * mbw) + 4 * c));
    f.mv[0] = m.x;
    f.mv[1] = m.y;
    f.mv[2] = m.z;
    f.mv[3] = m.w;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f.mh[e] = __ldg(P.mapsH + (size_t)(4 * r + e) * W + 16 * c + t);
    }
  } else if (t >= 32 && lane < 16) {
    const int row = lane & 7;
    const int2 m = __ldg(reinterpret_cast<const int2*>(
        P.mapsVc + (size_t)(8 * r + row) * (2 * mbw) + 2 * c));
    f.mv[0] = m.x;
    f.mv[1] = m.y;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      f.mh[e] = __ldg(P.mapsHc + (size_t)(2 * r + e) * Wc + 8 * c + row);
    }
  }
}

__device__ __forceinline__ void store4(int32_t* d, int4 v) {
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}

__device__ __forceinline__ int4 load4(const int32_t* s) {
  return make_int4(s[0], s[1], s[2], s[3]);
}

__global__ void __launch_bounds__(kThreads)
deblock_rows_kernel(Planes P, int H, int* __restrict__ progress) {
  // two tiles, A (MB c) and B (MB c + 1), each MB c in ty[c & 1]:
  // luma rows 0-3 the halo above, rows 4-19 the MB rows; columns 0-3 the
  // halo on the left, 4-19 the MB.  Chroma the same with a 2-pixel halo.
  __shared__ int32_t ty[2][20][kLS];
  __shared__ int32_t tc[2][2][10][kCS];
  __shared__ int s_row;
  const int W = P.W, mbw = W / 16, Wc = W / 2;
  const int t = threadIdx.x, lane = t & 31;

  if (t == 0) s_row = atomicAdd(progress, 1);
  for (int i = t; i < 2 * 20 * kLS; i += kThreads) (&ty[0][0][0])[i] = 0;
  for (int i = t; i < 4 * 10 * kCS; i += kThreads) (&tc[0][0][0][0])[i] = 0;
  __syncthreads();
  const int r = s_row;
  if (r >= H / 16) return;
  const int* above = progress + kFlagStride * r;        // row r-1's count
  int* mine = progress + kFlagStride * (r + 1);

  if (t >= kWorkers) {
    // the publisher: once the CTA has stored MB c (barrier 0), release
    // c + 1.  Its fence waits for those stores while the filtering warps
    // go on with the next MB.
    for (int c = 0; c < mbw; ++c) {
      __syncthreads();
      if (lane == 0) st_release(mine, c + 1);
    }
    return;
  }

  const bool luma = t < 32;
  const bool liner = lane < 16;           // a thread that filters a line
  const int cp = lane >> 3, cl = lane & 7;   // its chroma plane and line
  int seen = 0;                                          // thread 0 only
  int32_t mv[4], mhA[4], mhB[4];

  // the fetched MB into tile b; its maps become the thread's vertical
  // maps and its next horizontal maps
  auto put = [&](const Fetch& f, int b) {
    store4(&ty[b][4 + (t >> 2)][4 + 4 * (t & 3)], f.py);
    if (t < 32) {
      store4(&tc[b][t >> 4][2 + ((t & 15) >> 1)][2 + 4 * (t & 1)], f.pc);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      mv[e] = f.mv[e];
      mhB[e] = f.mh[e];
    }
  };
  // vertical edges of tile b, left to right: its left edge (first) or
  // the inner ones (!first)
  auto vertical = [&](int b, bool first) {
    if (!liner) return;
    if (luma) {
      for (int e = first ? 0 : 1; e < (first ? 1 : 4); ++e) {
        luma_line(&ty[b][4 + lane][4 + 4 * e], 1, mv[e]);
      }
    } else {
      chroma_line(&tc[b][cp][2 + cl][first ? 2 : 6], 1, mv[first ? 0 : 1]);
    }
  };

  // ---- prologue: MB 0 and its vertical edges (its left halo is 0) ----
  Fetch f;
  fetch(f, P, r, 0, t);
  put(f, 0);
  if (mbw > 1) fetch(f, P, r, 1, t);
  sync_workers();
  vertical(0, true);

  for (int c = 0; c < mbw; ++c) {
    const int a = c & 1, b = a ^ 1;
    const bool hasB = c + 1 < mbw;
    // A's inner vertical edges: only A's own pixels, which no other row
    // reads before A is stored, so they follow the last step's release
    vertical(a, false);
#pragma unroll
    for (int e = 0; e < 4; ++e) mhA[e] = mhB[e];
    if (hasB) put(f, b);
    // the MB after B is in flight while A waits
    if (c + 2 < mbw) fetch(f, P, r, c + 2, t);

    // ---- wait until row r-1 has stored MB c (after its horizontal edges
    // and the left edge of c + 1), then read the rows above A ----
    if (r > 0) {
      if (t == 0) {
        while (seen < c + 1) seen = ld_acquire(above);
      }
      sync_workers();
      if (t < 16) {
        const int i = t >> 2, q = t & 3;
        store4(&ty[a][i][4 + 4 * q], __ldcg(reinterpret_cast<const int4*>(
            P.y + (size_t)(16 * r - 4 + i) * W + 16 * c + 4 * q)));
      } else if (t >= 32 && t < 40) {
        const int p = (t - 32) >> 2, i = (t >> 1) & 1, q = t & 1;
        store4(&tc[a][p][i][2 + 4 * q], __ldcg(reinterpret_cast<const int4*>(
            P.c[p] + (size_t)(8 * r - 2 + i) * Wc + 8 * c + 4 * q)));
      }
    }
    sync_workers();

    // ---- horizontal edges of A, top to bottom: one thread per column ----
    if (liner) {
      if (luma) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          luma_line(&ty[a][4 + 4 * e][4 + lane], kLS, mhA[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          chroma_line(&tc[a][cp][2 + 4 * e][2 + cl], kCS, mhA[e]);
        }
      }
    }
    sync_workers();

    // ---- A's right columns become B's left halo; B's left edge ----
    if (hasB) {
      {
        const int i = t >> 2, j = t & 3;               // 16 rows x 4
        ty[b][4 + i][j] = ty[a][4 + i][16 + j];
      }
      if (t < 32) {
        const int p = t >> 4, i = (t & 15) >> 1, j = t & 1;
        tc[b][p][2 + i][j] = tc[a][p][2 + i][8 + j];
      }
      sync_workers();
      vertical(b, true);
    }
    sync_workers();

    // ---- A is final (its last 3 luma, 1 chroma columns now in B's
    // halo): store it with the rows above it that its top edge changed
    // (3 luma, 1 chroma) ----
    {
      const int i = t >> 2, q = t & 3;
      const int32_t* s = &ty[a][4 + i][4 + 4 * q];
      const int32_t* h = hasB ? &ty[b][4 + i][1] : s + 1;
      *reinterpret_cast<int4*>(P.y + (size_t)(16 * r + i) * W + 16 * c +
                               4 * q) =
          q < 3 ? load4(s) : make_int4(s[0], h[0], h[1], h[2]);
    }
    if (t < 32) {
      const int p = t >> 4, i = (t & 15) >> 1, q = t & 1;
      const int32_t* s = &tc[a][p][2 + i][2 + 4 * q];
      const int32_t last = hasB ? tc[b][p][2 + i][1] : s[3];
      *reinterpret_cast<int4*>(P.c[p] + (size_t)(8 * r + i) * Wc + 8 * c +
                               4 * q) =
          q == 0 ? load4(s) : make_int4(s[0], s[1], s[2], last);
    }
    if (r > 0) {
      if (t < 12) {
        const int i = t / 4 + 1, q = t & 3;
        *reinterpret_cast<int4*>(P.y + (size_t)(16 * r - 4 + i) * W +
                                 16 * c + 4 * q) = load4(&ty[a][i][4 + 4 * q]);
      } else if (t >= 32 && t < 36) {
        const int p = (t - 32) >> 1, q = t & 1;
        *reinterpret_cast<int4*>(P.c[p] + (size_t)(8 * r - 1) * Wc + 8 * c +
                                 4 * q) = load4(&tc[a][p][1][2 + 4 * q]);
      }
    }
    // the CTA's stores precede the publisher's release through barrier 0;
    // tile a is free for MB c + 2 after it
    __syncthreads();
  }
}

}  // namespace

// Plain C entry for ctypes: filters y, u, v in place with one launch on
// `stream`.  `progress` is int32 scratch of x264t_deblock_scratch_ints(H)
// words that the caller has zeroed on the same stream.  Every pointer is
// a device pointer.  Returns cudaGetLastError() after the launch.
extern "C" int x264t_deblock_scratch_ints(int H) {
  return kFlagStride * (H / 16 + 1);
}

extern "C" int x264t_deblock_apply(void* y, void* u, void* v, int H, int W,
                                   const void* mapsV, const void* mapsH,
                                   const void* mapsVc, const void* mapsHc,
                                   void* progress, void* stream) {
  if (H < 16 || W < 16 || H % 16 || W % 16) {
    return (int)cudaErrorInvalidValue;
  }
  Planes P;
  P.y = static_cast<int32_t*>(y);
  P.c[0] = static_cast<int32_t*>(u);
  P.c[1] = static_cast<int32_t*>(v);
  P.mapsV = static_cast<const int32_t*>(mapsV);
  P.mapsH = static_cast<const int32_t*>(mapsH);
  P.mapsVc = static_cast<const int32_t*>(mapsVc);
  P.mapsHc = static_cast<const int32_t*>(mapsHc);
  P.W = W;
  deblock_rows_kernel<<<H / 16, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      P, H, static_cast<int*>(progress));
  return (int)cudaGetLastError();
}
