// Full-search integer motion estimation: best (cost, offset) per partition
// shape, one CTA per macroblock, each thread a register-blocked tile of
// candidate offsets.  Hand-written for Hopper (sm_90a).
//
// Replaces: x264vfw_tpu/ops/pallas/sad.py :: sad_partition_minima (Pallas
// body _sad_argmin_kernel, and its width-tiled twin
// _sad_partition_minima_tiled, which computes the same thing).
//
// Contract (identical to the TPU kernel's docstring): src (H, W) and
// ref_pad (H + 2R, W + 2R, edge-padded) as uint8.  For every MB and every
// integer offset (dy, dx) in [-R, R]^2, with k = (dy + R) * K + (dx + R),
// K = 2R + 1, the four 8x8 quadrant SADs give six cost planes
//   cost_X = 4 * SAD_X + scales[X] * (|dy| + |dx|)
// for X = 16x16, 16x8 (top, bottom), 8x16 (left, right), 8x8 (four).
// Each plane keeps its lexicographic minimum (cost, k): ties go to the
// smallest k.  Outputs are int32: v16/k16 (mbh, mbw), v168/k168 and
// v816/k816 (mbh, mbw, 2), v8/k8 (2 mbh, 2 mbw).  Scales are at most
// kMaxScale, which keeps every cost below 2^23.
//
// What bounds it on an H100: integer instruction issue.  At 1080p with
// R = 16 one call forms 1,089 offsets x 2.09 M pixels = 2.27 G absolute
// byte differences, while the bytes it must move are ~4.9 MB (src 2.1 MB,
// ref_pad 2.2 MB, outputs 0.6 MB): about 460 byte-differences per byte
// read, far past the memory roofline.  The least issue is one
// vabsdiff4-with-accumulate (four pixels) per 4-pixel SAD.
//
// What the design does about it:
//   * the source MB (256 B) and its reference window are read from device
//     memory once per CTA into shared memory, the window by 32-bit words
//     with 16 rows' loads in flight per warp where its rows are aligned;
//   * each thread takes a tile of kV x 4 offsets: kV vertically adjacent
//     dy times the 4 dx that share ox >> 2 (ox = dx + R).  The candidate
//     grid is padded to whole tiles (K = 33: 35 x 36) and a padded
//     candidate can never win.  For each window row the thread loads the
//     5 aligned words once, forms the 4 byte shifts with __byte_perm and
//     constant selectors, and serves all 4 dx and every dy whose source
//     row meets that window row; each source row is one 16-byte broadcast
//     load, kept in registers while kV window rows use it.  The 4 x kV x 4
//     quadrant sums stay in registers; every 4-pixel SAD is one
//     vabsdiff4.add into its sum (one VABSDIFF4 in the SASS; the inner
//     loop is ~1.3 SASS instructions per 4-pixel SAD on sm_90a);
//   * threads per CTA are the tiles rounded up to whole warps (R = 16:
//     63 tiles, 64 threads);
//   * a thread visits its candidates in increasing k, so its running
//     minimum per plane is one 32-bit key (cost << 5 | index in the tile)
//     and one unsigned min; the key is widened to (cost << 32 | k) for the
//     warp shuffle plus shared-memory pass that finish the CTA.  A minimum
//     does not depend on the order of reduction, so the result is exact
//     and deterministic.
// The TPU kernel's bf16 byte-split matmuls, 128-lane padding, band
// stacking and VMEM width strips have no counterpart here.
//
// Quad mode (x264t_sad_search_quad) replaces
// x264vfw_tpu/ops/pallas/sad.py :: sad_search_quad (Pallas body _sad_kernel):
// every offset's four quadrant SADs unreduced, (K^2, 2mbh, 2mbw) int32 with
// entry [k, qy, qx] the SAD of the 8x8 block at (8qy, 8qx) displaced by
// (k / K - R, k % K - R).  That output is K^2 / 2.25 times the inputs'
// bytes (142 MB at 1080p, R = 16, 0.044 ms of stores at 3.35 TB/s), so the
// store path decides whether this mode is bound by its stores or by the
// same tile loop as the minima.  Its kernel (sad_quad_kernel) runs the
// same tile loop over a strip of kStrip = 16 MBs in one MB row, so that a
// plane's row segment is 2 x 16 int32 = 128 contiguous bytes:
//   * a persistent grid (one CTA per SM) walks work units (strip, round);
//     a round is kRoundTiles tiles of every MB of the strip, one tile per
//     SAD thread.  A CTA takes every round of one strip in turn (it loads
//     the strip's source rows and window once), while the CTAs beside it
//     take the strips beside it with the same round, so that a plane row
//     (960 B at 1080p) is written whole at about the same time;
//   * the SAD threads stage a round's quadrant sums in shared memory by
//     plane row, in one of two buffers; a warpgroup of store threads
//     writes the staged rows out as whole 128-byte row segments with
//     coalesced 16-byte stores, eight loads in flight before their stores
//     (4-byte stores where a row segment is not 16-byte aligned), while
//     the SAD threads form the next round in the other buffer;
//     named barriers (bar.arrive / bar.sync) hand the buffers over.  When
//     every CTA instead stores and then forms SADs in turn, the whole card
//     does the two one after the other;
//   * 256 SAD + 128 store threads at 168 registers fill the register file
//     of one SM without spills.
// No encode path runs quad mode.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kV = 5;               // vertically adjacent offsets per tile
constexpr int kMaxThreads = 256;
constexpr int kMaxR = 32;
constexpr int kMaxScale = 1 << 16;
constexpr int kPlanes = 9;          // 16x16, 16x8 x2, 8x16 x2, 8x8 x4
constexpr uint32_t kPadKey = 0xF0000000u;   // above every real key (< 2^28)

// quad mode
constexpr int kStrip = 16;           // MBs per strip: 128-byte row segments
constexpr int kRoundTiles = 16;      // tiles of every MB per round
constexpr int kSadThreads = kStrip * kRoundTiles;   // one tile each
constexpr int kStoreThreads = 128;   // a warpgroup writes the rows out
constexpr int kQuadThreads = kSadThreads + kStoreThreads;
constexpr int kRowInts = 2 * kStrip;            // ints of a staged plane row
constexpr int kTileRows = kV * 4 * 2;   // staged rows per tile: a, b, qy
constexpr int kTileInts = kTileRows * kRowInts + 4;   // tiles 4 banks apart
constexpr int kStageInts = kRoundTiles * kTileInts;   // one staging buffer
constexpr int kRoundPairs = kRoundTiles * kV * 4;     // (tile, a, b) per round
// named barriers (0 is __syncthreads): the SAD threads among themselves,
// and per staging buffer "full" (SAD threads arrive, store threads wait)
// and "empty" (store threads arrive, SAD threads wait)
constexpr int kBarSad = 1, kBarFull = 2, kBarEmpty = 4;

struct Outputs {
  int32_t* v16;
  int32_t* k16;
  int32_t* v168;
  int32_t* k168;
  int32_t* v816;
  int32_t* k816;
  int32_t* v8;
  int32_t* k8;
};

// Geometry of the padded candidate grid and the shared window.
struct Geometry {
  int cols;     // tiles across: ceil(K / 4)
  int rows;     // tiles down: ceil(K / kV)
  int stride;   // 32-bit words per shared window row
  int wrows;    // shared window rows
  int threads;  // tiles rounded up to whole warps
  size_t smem;  // dynamic shared bytes: src + window
};

Geometry geometry(int R) {
  const int K = 2 * R + 1;
  Geometry g;
  g.cols = (K + 3) / 4;
  g.rows = (K + kV - 1) / kV;
  // the last tile reads words cols - 1 .. cols + 3 of a row.  The stride
  // (at most 32: one lane per word when the window is loaded) is padded
  // where it can be so that the kV-row step between tiles of one warp
  // moves the bank by `cols`, and lanes of neighbouring tile rows hit
  // distinct banks
  g.stride = g.cols + 4;
  for (int s = g.cols + 4; s <= 32; ++s) {
    if ((kV * s) % 32 == g.cols % 32) {
      g.stride = s;
      break;
    }
  }
  g.wrows = kV * g.rows + 15;
  g.threads = (g.cols * g.rows + 31) / 32 * 32;
  g.smem = 256 + (size_t)g.wrows * g.stride * 4;
  return g;
}

// Geometry of quad mode's strips: the tile grid as above, the strip's
// shared window (kStrip MB windows side by side) and the shared bytes.
struct QuadGeometry {
  int cols, rows;   // tiles across and down, as in Geometry
  int rounds;       // rounds of kRoundTiles tiles per strip
  int stride;       // 32-bit words per shared window row
  int wrows;        // shared window rows
  size_t smem;      // dynamic shared bytes: src, window, 2 x (staging,
                    // plane ids)
};

QuadGeometry quad_geometry(int R) {
  const int K = 2 * R + 1;
  QuadGeometry g;
  g.cols = (K + 3) / 4;
  g.rows = (K + kV - 1) / kV;
  g.rounds = (g.cols * g.rows + kRoundTiles - 1) / kRoundTiles;
  // MB m's tiles read words 4m + tile_x .. + 4; as in geometry(), the
  // stride moves the bank by `cols` per kV rows, so that the lanes of one
  // MB's neighbouring tile rows hit distinct banks
  const int base = 4 * (kStrip - 1) + g.cols + 4;
  g.stride = base;
  for (int s = base; s < base + 32; ++s) {
    if ((kV * s) % 32 == g.cols % 32) {
      g.stride = s;
      break;
    }
  }
  g.wrows = kV * g.rows + 15;
  const size_t win_words = ((size_t)g.wrows * g.stride + 3) / 4 * 4;
  g.smem = (size_t)kStrip * 256 + win_words * 4 +
           2 * ((size_t)kStageInts + kRoundPairs) * 4;
  return g;
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    unsigned long long w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w < v ? w : v;
  }
  return v;
}

// acc + the sum of the four absolute byte differences of a and b
__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b,
                                         uint32_t acc) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d) : "r"(a), "r"(b), "r"(acc));
  return d;
}

// Bytes c .. c + 3 of window row r (0 past the window's nrows x ncols) by
// byte loads, for a window whose rows are not 4-byte aligned in ref_pad.
__device__ uint32_t window_word(const uint8_t* ref_pad, int Wp, int y0,
                                int x0, int r, int c, int nrows, int ncols) {
  uint32_t v = 0;
  if (r < nrows) {
    const uint8_t* g = ref_pad + (size_t)(y0 + r) * Wp + x0;
    for (int i = 0; i < 4 && c + i < ncols; ++i) {
      v |= (uint32_t)__ldg(g + c + i) << (8 * i);
    }
  }
  return v;
}

// The quadrant SADs of one tile of kV x 4 candidate offsets: q[a][b][h]
// for offset (oy0 + a, ox0 + b), quadrants h = TL, TR, BL, BR.  wbase is
// window row oy0, word ox0 / 4 of the MB's window; s_src its 16 source
// rows.  For each window row the 5 aligned words are loaded once, the 4
// byte shifts formed with __byte_perm and constant selectors, and every
// dy whose source row meets that window row served; each source row is
// one 16-byte load, kept in registers while kV window rows use it.
__device__ __forceinline__ void tile_sads(const uint32_t* wbase, int stride,
                                          const uint4* s_src,
                                          uint32_t (&q)[kV][4][4]) {
#pragma unroll
  for (int a = 0; a < kV; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int h = 0; h < 4; ++h) q[a][b][h] = 0;

  uint4 srow[16];
#pragma unroll
  for (int s = 0; s < 15 + kV; ++s) {      // window row oy0 + s
    if (s < 16) srow[s] = s_src[s];
    const uint32_t* row = wbase + s * stride;
    uint32_t w[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) w[i] = row[i];
    uint32_t sh[4][4];                      // [dx & 3][word]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sh[0][i] = w[i];
      sh[1][i] = __byte_perm(w[i], w[i + 1], 0x4321);
      sh[2][i] = __byte_perm(w[i], w[i + 1], 0x5432);
      sh[3][i] = __byte_perm(w[i], w[i + 1], 0x6543);
    }
#pragma unroll
    for (int a = 0; a < kV; ++a) {
      const int r = s - a;                  // source row
      if (r < 0 || r >= 16) continue;
      const int h = r < 8 ? 0 : 2;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        q[a][b][h] = sad4(srow[r].x, sh[b][0], q[a][b][h]);
        q[a][b][h] = sad4(srow[r].y, sh[b][1], q[a][b][h]);
        q[a][b][h + 1] = sad4(srow[r].z, sh[b][2], q[a][b][h + 1]);
        q[a][b][h + 1] = sad4(srow[r].w, sh[b][3], q[a][b][h + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
sad_minima_kernel(const uint8_t* __restrict__ src,
                  const uint8_t* __restrict__ ref_pad, int W, int R,
                  int cols, int rows, int stride, int s0, int s1, int s2,
                  int s3, Outputs out) {
  extern __shared__ uint4 smem4[];
  __shared__ unsigned long long red[kPlanes][kMaxThreads / 32];

  const int K = 2 * R + 1;
  const int win = 16 + 2 * R;
  const int wrows = kV * rows + 15;
  const int mbx = blockIdx.x;
  const int mby = blockIdx.y;
  const int mbw = gridDim.x;
  const int Wp = W + 2 * R;
  const int t = threadIdx.x;

  const uint4* s_src = smem4;                          // 16 rows x 16 B
  uint8_t* s_src8 = reinterpret_cast<uint8_t*>(smem4);
  uint32_t* s_win = reinterpret_cast<uint32_t*>(smem4 + 16);

  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    if (t < 16) {
      smem4[t] = __ldg(reinterpret_cast<const uint4*>(
          src + (size_t)(16 * mby + t) * W + 16 * mbx));
    }
  } else {
    for (int i = t; i < 256; i += blockDim.x) {
      s_src8[i] = src[(size_t)(16 * mby + (i >> 4)) * W + 16 * mbx +
                      (i & 15)];
    }
  }
  // the window by 32-bit words; words past the window (the padded
  // candidates' reach) are 0.  Where every row is 4-byte aligned (R even)
  // one warp takes a row and a lane a word, 16 rows' loads in flight at
  // once.
  if (((reinterpret_cast<uintptr_t>(ref_pad) | (uintptr_t)Wp) & 3) == 0) {
    const int nwarps = blockDim.x >> 5, lane = t & 31, c = 4 * lane;
    for (int r0 = t >> 5; r0 < wrows; r0 += 16 * nwarps) {
      uint32_t v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int r = r0 + u * nwarps;
        v[u] = (r < win && c < win)
            ? __ldg(reinterpret_cast<const uint32_t*>(
                  ref_pad + (size_t)(16 * mby + r) * Wp + 16 * mbx + c))
            : 0u;
      }
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        const int r = r0 + u * nwarps;
        if (r < wrows && lane < stride) s_win[r * stride + lane] = v[u];
      }
    }
  } else {
    for (int i = t; i < wrows * stride; i += blockDim.x) {
      const int r = i / stride;
      s_win[i] = window_word(ref_pad, Wp, 16 * mby, 16 * mbx, r,
                             4 * (i - r * stride), win, win);
    }
  }
  __syncthreads();

  const int tile_y = t / cols, tile_x = t - tile_y * cols;
  const int oy0 = kV * tile_y, ox0 = 4 * tile_x;
  uint32_t key[kPlanes];
#pragma unroll
  for (int j = 0; j < kPlanes; ++j) key[j] = ~0u;

  if (tile_y < rows) {
    uint32_t q[kV][4][4];
    tile_sads(s_win + oy0 * stride + tile_x, stride, s_src, q);

#pragma unroll
    for (int a = 0; a < kV; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int oy = oy0 + a, ox = ox0 + b;
        const bool real = oy < K && ox < K;
        const uint32_t* qq = q[a][b];
        // key = (4 * SAD + s * pen) << 5 | index = SAD * 128 + c_s
        const uint32_t pen = (uint32_t)(abs(oy - R) + abs(ox - R));
        const uint32_t idx = (uint32_t)(4 * a + b);
        const uint32_t c0 = real ? ((s0 * pen) << 5 | idx) : kPadKey;
        const uint32_t c1 = real ? ((s1 * pen) << 5 | idx) : kPadKey;
        const uint32_t c2 = real ? ((s2 * pen) << 5 | idx) : kPadKey;
        const uint32_t c3 = real ? ((s3 * pen) << 5 | idx) : kPadKey;
        const uint32_t top = qq[0] + qq[1], bot = qq[2] + qq[3];
        const uint32_t lft = qq[0] + qq[2], rgt = qq[1] + qq[3];
        key[0] = min(key[0], (top + bot) * 128u + c0);
        key[1] = min(key[1], top * 128u + c1);
        key[2] = min(key[2], bot * 128u + c1);
        key[3] = min(key[3], lft * 128u + c2);
        key[4] = min(key[4], rgt * 128u + c2);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          key[5 + h] = min(key[5 + h], qq[h] * 128u + c3);
        }
      }
    }
  }

  const int lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int j = 0; j < kPlanes; ++j) {
    unsigned long long p = ~0ull;
    if (key[j] < kPadKey) {
      const uint32_t idx = key[j] & 31u;
      const uint32_t k = (uint32_t)((oy0 + (int)(idx >> 2)) * K + ox0 +
                                    (int)(idx & 3u));
      p = ((unsigned long long)(key[j] >> 5) << 32) | k;
    }
    const unsigned long long v = warp_min(p);
    if (lane == 0) red[j][warp] = v;
  }
  __syncthreads();
  if (t < kPlanes) {
    const int j = t;
    unsigned long long v = red[j][0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
      v = red[j][w] < v ? red[j][w] : v;
    }
    const int32_t c = (int32_t)(v >> 32);
    const int32_t kk = (int32_t)(v & 0xffffffffu);
    const int mb = mby * mbw + mbx;
    if (j == 0) {
      out.v16[mb] = c;
      out.k16[mb] = kk;
    } else if (j < 3) {
      out.v168[2 * mb + j - 1] = c;
      out.k168[2 * mb + j - 1] = kk;
    } else if (j < 5) {
      out.v816[2 * mb + j - 3] = c;
      out.k816[2 * mb + j - 3] = kk;
    } else {
      const int qd = j - 5;
      const int i8 = (2 * mby + (qd >> 1)) * (2 * mbw) + 2 * mbx + (qd & 1);
      out.v8[i8] = c;
      out.k8[i8] = kk;
    }
  }
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

// The strip and round of unit v when a grid of G CTAs takes units c,
// c + G, c + 2G, ... (CTA c).  Units come in blocks of G strips x rounds:
// in block b, unit w of the block is round w / G' of strip b G + w % G',
// G' = min(G, nstrips - b G).  So a CTA takes every round of one strip in
// turn, while the CTAs beside it take the strips beside it with the same
// round: together they write whole plane rows at a time.
__device__ __forceinline__ void unit_strip(int v, int G, int nstrips,
                                           int rounds, int* strip, int* rd) {
  const int b = v / (G * rounds);
  const int w = v - b * G * rounds;
  const int gb = min(G, nstrips - b * G);
  *rd = w / gb;
  *strip = b * G + (w - *rd * gb);
}

// Quad mode: a persistent grid over units (strip, round) in the order of
// unit_strip.  Threads below kSadThreads form SADs: thread t takes MB
// t / kRoundTiles of the strip and tile round * kRoundTiles + t %
// kRoundTiles, and stages its sums in buffer n & 1 for the CTA's n-th
// unit; the kStoreThreads above write each staged round out while the
// SAD threads form the next one.
__global__ void __launch_bounds__(kQuadThreads, 1)
sad_quad_kernel(const uint8_t* __restrict__ src,
                const uint8_t* __restrict__ ref_pad, int W, int mbh, int R,
                QuadGeometry g, int units, int32_t* __restrict__ quad) {
  extern __shared__ uint4 smem4[];
  uint4* s_src = smem4;                                 // [kStrip][16 rows]
  uint32_t* s_win = reinterpret_cast<uint32_t*>(smem4 + kStrip * 16);
  int32_t* s_stage = reinterpret_cast<int32_t*>(
      s_win + ((size_t)g.wrows * g.stride + 3) / 4 * 4);  // [2][kStageInts]
  int32_t* s_k = s_stage + 2 * kStageInts;     // [2][kRoundPairs]: plane id

  const int K = 2 * R + 1;
  const int win = 16 + 2 * R;
  const int mbw = W >> 4;
  const int nsx = (mbw + kStrip - 1) / kStrip;
  const int Wp = W + 2 * R;
  const int tiles = g.cols * g.rows;
  const int t = threadIdx.x;
  const int G = gridDim.x;

  if (t >= kSadThreads) {
    // ---- store threads: staged rows out, whole row segments -------------
    // row i of a round is staging row (tile i / kTileRows, a, b, qy); in
    // the output it is plane k, row 2 smby + qy, ints 2 mbx0 ..
    const int st = t - kSadThreads;
    const size_t plane = (size_t)(2 * mbh) * (2 * mbw);
    const bool vec = ((reinterpret_cast<uintptr_t>(quad) & 15) == 0) &&
                     mbw % 2 == 0;             // mbw even: so is every nmb
    for (int u = blockIdx.x, n = 0; u < units; u += G, ++n) {
      const int buf = n & 1;
      int sid, rd;
      unit_strip(u, G, units / g.rounds, g.rounds, &sid, &rd);
      const int smby = sid / nsx, mbx0 = (sid - smby * nsx) * kStrip;
      const int nmb = min(kStrip, mbw - mbx0);
      int32_t* dst = quad + (size_t)(2 * smby) * (2 * mbw) + 2 * mbx0;
      const int32_t* stage = s_stage + buf * kStageInts;
      const int32_t* ks = s_k + buf * kRoundPairs;
      named_sync(kBarFull + buf, kQuadThreads);
      if (vec) {
        // 16-byte chunks, kBatch loads in flight before their stores
        constexpr int kBatch = 8;
        const int chunks = nmb / 2;            // per row segment
        for (int i0 = st; i0 < kRoundTiles * kTileRows * 8;
             i0 += kBatch * kStoreThreads) {
          int4 val[kBatch];
          int32_t* to[kBatch];
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            const int i = i0 + j * kStoreThreads;
            const int row = i >> 3, ch = i & 7;
            const int k = i < kRoundTiles * kTileRows * 8 ? ks[row >> 1] : -1;
            to[j] = nullptr;
            if (ch < chunks && k >= 0) {
              const int tt = row / kTileRows, rem = row - tt * kTileRows;
              val[j] = *reinterpret_cast<const int4*>(
                  stage + tt * kTileInts + rem * kRowInts + 4 * ch);
              to[j] = dst + k * plane + (row & 1) * (2 * mbw) + 4 * ch;
            }
          }
#pragma unroll
          for (int j = 0; j < kBatch; ++j) {
            if (to[j]) *reinterpret_cast<int4*>(to[j]) = val[j];
          }
        }
      } else {
        for (int i = st; i < kRoundTiles * kTileRows * kRowInts;
             i += kStoreThreads) {
          const int row = i / kRowInts, ch = i % kRowInts;
          const int k = ks[row >> 1];
          if (ch < 2 * nmb && k >= 0) {
            const int tt = row / kTileRows, rem = row - tt * kTileRows;
            dst[k * plane + (row & 1) * (2 * mbw) + ch] =
                stage[tt * kTileInts + rem * kRowInts + ch];
          }
        }
      }
      // the SAD threads wait for this buffer again two units on
      if (u + 2 * G < units) named_arrive(kBarEmpty + buf, kQuadThreads);
    }
    return;
  }

  // ---- SAD threads ---------------------------------------------------------
  const int lane = t & 31, warp = t >> 5;
  const int m = t / kRoundTiles, tl = t % kRoundTiles;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(ref_pad) | (uintptr_t)Wp) & 3) == 0;
  int loaded = -1;
  for (int u = blockIdx.x, n = 0; u < units; u += G, ++n) {
    const int buf = n & 1;
    int sid, rd;
    unit_strip(u, G, units / g.rounds, g.rounds, &sid, &rd);
    const int smby = sid / nsx, mbx0 = (sid - smby * nsx) * kStrip;
    const int nmb = min(kStrip, mbw - mbx0);

    if (sid != loaded) {                 // the strip's source rows, window
      loaded = sid;
      named_sync(kBarSad, kSadThreads);  // every SAD of the last strip done
      {
        const int mm = t >> 4, rr = t & 15;   // kSadThreads = kStrip x 16
        uint4 v = make_uint4(0, 0, 0, 0);
        if (mm < nmb) {
          const uint8_t* p = src + (size_t)(16 * smby + rr) * W +
                             16 * (mbx0 + mm);
          if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
            v = __ldg(reinterpret_cast<const uint4*>(p));
          } else {
            uint32_t b[4] = {0, 0, 0, 0};
            for (int i = 0; i < 16; ++i) {
              b[i >> 2] |= (uint32_t)__ldg(p + i) << (8 * (i & 3));
            }
            v = make_uint4(b[0], b[1], b[2], b[3]);
          }
        }
        s_src[t] = v;
      }
      // window rows 16 smby .., columns 16 mbx0 .. 16 (mbx0 + nmb) + 2R;
      // 0 past them
      const int wcols = 16 * nmb + 2 * R;
      if (aligned) {
        const uint8_t* base = ref_pad + (size_t)(16 * smby) * Wp + 16 * mbx0;
        for (int r0 = warp; r0 < g.wrows; r0 += 8 * (kSadThreads / 32)) {
          for (int c = lane; c < g.stride; c += 32) {
            uint32_t v[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const int r = r0 + k * (kSadThreads / 32);
              v[k] = (r < win && 4 * c < wcols)
                  ? __ldg(reinterpret_cast<const uint32_t*>(
                        base + (size_t)r * Wp + 4 * c))
                  : 0u;
            }
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const int r = r0 + k * (kSadThreads / 32);
              if (r < g.wrows) s_win[r * g.stride + c] = v[k];
            }
          }
        }
      } else {
        for (int i = t; i < g.wrows * g.stride; i += kSadThreads) {
          const int r = i / g.stride;
          s_win[i] = window_word(ref_pad, Wp, 16 * smby, 16 * mbx0, r,
                                 4 * (i - r * g.stride), win, wcols);
        }
      }
      named_sync(kBarSad, kSadThreads);  // the strip is in place
    }

    const int tile = rd * kRoundTiles + tl;
    const bool mine = tile < tiles && m < nmb;
    uint32_t q[kV][4][4];
    if (mine) {
      const int tile_y = tile / g.cols, tile_x = tile - tile_y * g.cols;
      tile_sads(s_win + kV * tile_y * g.stride + 4 * m + tile_x, g.stride,
                s_src + 16 * m, q);
    }
    // the store threads are done with this buffer's last round
    if (n >= 2) named_sync(kBarEmpty + buf, kQuadThreads);
    int32_t* ks = s_k + buf * kRoundPairs;
    for (int i = t; i < kRoundPairs; i += kSadThreads) {
      const int tt = rd * kRoundTiles + i / (kV * 4), ab = i % (kV * 4);
      int k = -1;                        // -1: a padded offset
      if (tt < tiles) {
        const int ty = tt / g.cols, tx = tt - ty * g.cols;
        const int oy = kV * ty + (ab >> 2), ox = 4 * tx + (ab & 3);
        if (oy < K && ox < K) k = oy * K + ox;
      }
      ks[i] = k;
    }
    if (mine) {
      int32_t* st = s_stage + buf * kStageInts + tl * kTileInts + 2 * m;
#pragma unroll
      for (int a = 0; a < kV; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int qy = 0; qy < 2; ++qy) {
            *reinterpret_cast<int2*>(st + ((a * 4 + b) * 2 + qy) * kRowInts) =
                make_int2((int)q[a][b][2 * qy], (int)q[a][b][2 * qy + 1]);
          }
    }
    named_arrive(kBarFull + buf, kQuadThreads);
  }
}

bool bad_geometry(int H, int W, int R) {
  return H < 16 || W < 16 || H % 16 || W % 16 || R < 1 || R > kMaxR;
}

// CTAs of sad_quad_kernel that fit on the current device at once with
// `smem` dynamic shared bytes (the attribute set and the occupancy read
// on the first launch of each device and size, so that later launches,
// for instance while a CUDA graph is captured, make no such call).
int quad_grid(size_t smem, int* grid) {
  static int c_dev = -1, c_grid = 0;
  static size_t c_smem = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != c_dev || smem != c_smem) {
    int sms = 0, per_sm = 0;
    e = cudaFuncSetAttribute(sad_quad_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sad_quad_kernel, kQuadThreads, smem);
    }
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    c_dev = dev;
    c_smem = smem;
    c_grid = sms * per_sm;
  }
  *grid = c_grid;
  return 0;
}

}  // namespace

// Plain C entry for ctypes.  Every pointer is a device pointer; `stream` is
// the caller's cudaStream_t.  Returns cudaGetLastError() after the launch.
extern "C" int x264t_sad_partition_minima(
    const void* src, const void* ref_pad, int H, int W, int R, int s0,
    int s1, int s2, int s3, void* v16, void* k16, void* v168, void* k168,
    void* v816, void* k816, void* v8, void* k8, void* stream) {
  if (bad_geometry(H, W, R) || s0 < 0 || s1 < 0 || s2 < 0 || s3 < 0 ||
      s0 > kMaxScale || s1 > kMaxScale || s2 > kMaxScale ||
      s3 > kMaxScale) {
    return (int)cudaErrorInvalidValue;
  }
  const Outputs out = {
      static_cast<int32_t*>(v16), static_cast<int32_t*>(k16),
      static_cast<int32_t*>(v168), static_cast<int32_t*>(k168),
      static_cast<int32_t*>(v816), static_cast<int32_t*>(k816),
      static_cast<int32_t*>(v8), static_cast<int32_t*>(k8)};
  const Geometry g = geometry(R);
  const dim3 grid(W / 16, H / 16);
  sad_minima_kernel<<<grid, g.threads, g.smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(ref_pad),
      W, R, g.cols, g.rows, g.stride, s0, s1, s2, s3, out);
  return (int)cudaGetLastError();
}

// Quad mode: every offset's unreduced quadrant SADs into `quad`
// (K^2, 2H/16, 2W/16) int32.  Returns cudaGetLastError() after the launch.
extern "C" int x264t_sad_search_quad(const void* src, const void* ref_pad,
                                     int H, int W, int R, void* quad,
                                     void* stream) {
  if (bad_geometry(H, W, R)) return (int)cudaErrorInvalidValue;
  const QuadGeometry g = quad_geometry(R);
  const int mbw = W / 16, mbh = H / 16;
  const int units = mbh * ((mbw + kStrip - 1) / kStrip) * g.rounds;
  int grid = 0;
  const int rc = quad_grid(g.smem, &grid);
  if (rc != 0) return rc;
  sad_quad_kernel<<<units < grid ? units : grid, kQuadThreads, g.smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(ref_pad),
      W, mbh, R, g, units, static_cast<int32_t*>(quad));
  return (int)cudaGetLastError();
}
