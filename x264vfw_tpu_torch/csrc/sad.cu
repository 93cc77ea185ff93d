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
// the same kernel, instantiated to write every offset's four quadrant SADs
// unreduced, (K^2, 2mbh, 2mbw) int32 with entry [k, qy, qx] the SAD of the
// 8x8 block at (8qy, 8qx) displaced by (k / K - R, k % K - R).  That output
// is K^2 / 2.25 times the inputs' bytes (142 MB at 1080p, R = 16), so
// this mode is bound by its stores; no encode path runs it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kV = 5;               // vertically adjacent offsets per tile
constexpr int kMaxThreads = 256;
constexpr int kMaxR = 32;
constexpr int kMaxScale = 1 << 16;
constexpr int kPlanes = 9;          // 16x16, 16x8 x2, 8x16 x2, 8x8 x4
constexpr uint32_t kPadKey = 0xF0000000u;   // above every real key (< 2^28)

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

// Bytes c .. c + 3 of window row r (0 past the window) by byte loads,
// for a window whose rows are not 4-byte aligned in ref_pad.
__device__ uint32_t window_word(const uint8_t* ref_pad, int Wp, int y0,
                                int x0, int r, int c, int win) {
  uint32_t v = 0;
  if (r < win) {
    const uint8_t* g = ref_pad + (size_t)(y0 + r) * Wp + x0;
    for (int i = 0; i < 4 && c + i < win; ++i) {
      v |= (uint32_t)__ldg(g + c + i) << (8 * i);
    }
  }
  return v;
}

template <bool kQuad>
__global__ void __launch_bounds__(kMaxThreads)
sad_tiles_kernel(const uint8_t* __restrict__ src,
                 const uint8_t* __restrict__ ref_pad, int W, int R,
                 int cols, int rows, int stride, int s0, int s1, int s2,
                 int s3, Outputs out, int32_t* __restrict__ quad) {
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
                             4 * (i - r * stride), win);
    }
  }
  __syncthreads();

  const int tile_y = t / cols, tile_x = t - tile_y * cols;
  const int oy0 = kV * tile_y, ox0 = 4 * tile_x;
  uint32_t key[kPlanes];
#pragma unroll
  for (int j = 0; j < kPlanes; ++j) key[j] = ~0u;

  if (tile_y < rows) {
    // q[a][b][0..3]: TL, TR, BL, BR quadrant SADs of offset (oy0+a, ox0+b)
    uint32_t q[kV][4][4];
#pragma unroll
    for (int a = 0; a < kV; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
#pragma unroll
        for (int h = 0; h < 4; ++h) q[a][b][h] = 0;

    const uint32_t* wbase = s_win + oy0 * stride + tile_x;
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

#pragma unroll
    for (int a = 0; a < kV; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int oy = oy0 + a, ox = ox0 + b;
        const bool real = oy < K && ox < K;
        const uint32_t* qq = q[a][b];
        if (kQuad) {
          if (real) {
            const int mbh = gridDim.y;
            int32_t* o = quad + ((size_t)(oy * K + ox) * 2 * mbh + 2 * mby) *
                                    (2 * mbw) + 2 * mbx;
            *reinterpret_cast<int2*>(o) = make_int2(qq[0], qq[1]);
            *reinterpret_cast<int2*>(o + 2 * mbw) = make_int2(qq[2], qq[3]);
          }
          continue;
        }
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

  if (kQuad) return;
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

template <bool kQuad>
int launch(const void* src, const void* ref_pad, int H, int W, int R,
           int s0, int s1, int s2, int s3, const Outputs& out, void* quad,
           void* stream) {
  const Geometry g = geometry(R);
  const dim3 grid(W / 16, H / 16);
  sad_tiles_kernel<kQuad><<<grid, g.threads, g.smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(ref_pad),
      W, R, g.cols, g.rows, g.stride, s0, s1, s2, s3, out,
      static_cast<int32_t*>(quad));
  return (int)cudaGetLastError();
}

bool bad_geometry(int H, int W, int R) {
  return H < 16 || W < 16 || H % 16 || W % 16 || R < 1 || R > kMaxR;
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
  return launch<false>(src, ref_pad, H, W, R, s0, s1, s2, s3, out, nullptr,
                       stream);
}

// Quad mode: every offset's unreduced quadrant SADs into `quad`
// (K^2, 2H/16, 2W/16) int32.  Returns cudaGetLastError() after the launch.
extern "C" int x264t_sad_search_quad(const void* src, const void* ref_pad,
                                     int H, int W, int R, void* quad,
                                     void* stream) {
  if (bad_geometry(H, W, R)) return (int)cudaErrorInvalidValue;
  return launch<true>(src, ref_pad, H, W, R, 0, 0, 0, 0, Outputs{}, quad,
                      stream);
}
