// Quarter-pel refinement grouped by partition, plus luma motion
// compensation, one CTA per macroblock.  Hand-written for Hopper (sm_90a).
//
// Replaces: x264vfw_tpu/ops/pallas/memc.py :: partition_refine_mc (Pallas
// body _memc_kernel), whose golden model is
// x264vfw_tpu/encode/inter_partition.py :: _refine_and_mc_xla.
//
// Contract: src (H, W) and ref_pad (H + 2P, W + 2P), P = R + 8, edge-padded,
// as uint8; mv8i (2mbh, 2mbw, 2) int32 integer-pel [x, y] per 8x8 block,
// each component in [-R, R]; part (mbh, mbw) int32 in {0: 16x16, 1: 16x8,
// 2: 8x16, 3: 8x8}; sub_lv 0/1/2 selects 1, 9 or 25 quarter-pel candidates
// (tx, ty), ty outer.  Per 8x8 block, at the block's OWN integer vector:
// the spec 6-tap half-pel samples b, h, j (§8.4.2.2.1; j from the
// unrounded b intermediate, (j1 + 512) >> 10, int32), each candidate's
// prediction (a + b + 1) >> 1 of its two operand samples (Table 8-12) and
// its SAD.  The SADs of a partition's blocks are summed (16x8 pairs
// top/bottom, 8x16 left/right), the partition keeps the lexicographic
// minimum of (4*SAD + |tx| + |ty|, candidate index), and its blocks get
// mv8 = 4*mv8i + (tx, ty) and the winner's prediction.  Outputs: mv8
// (2mbh, 2mbw, 2) int32 and pred (H, W) int32.
//
// What bounds it on an H100: device-memory bytes.  At 1080p one call must
// read src (2.1 MB) and the padded reference (2.2 MB) and write pred as
// int32 (8.4 MB) and mv8 (0.3 MB): ~13 MB.  The work per pixel is about
// 25 candidates x 6 integer operations plus the 6-tap filters, ~0.4 G
// operations per frame, which the integer units clear far sooner than the
// bytes move.
//
// What the design does about it:
//   * each pixel of the reference window and of the source is read from
//     device memory once per CTA, and every intermediate (the raw 15x15
//     windows, the unrounded b intermediate, the int/b/h/j 10x10 sample
//     planes, the 4 x 25 SADs) stays in shared memory (~14 KB);
//   * one thread per (block, candidate) forms a SAD from shared memory, so
//     no partial sums cross threads; the partition's sum and its minimum
//     over at most 25 candidates are a short serial loop in the order of
//     the candidate index, which gives the JAX tie order exactly;
//   * each 8x8 block gathers its window at its own vector, so a candidate
//     read never uses a neighbour block's vector (the seam rule of the JAX
//     golden model), without the TPU kernel's aligned-variant planes,
//     band stacks, 128-lane padding or cost/index lookup table.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxR = 32;
constexpr int kWin = 15;   // raw window: samples -1 .. 8 plus taps -2 .. +3
constexpr int kS = 10;     // sample planes: offsets -1 .. 8 from the block

// Table 8-12 operand pairs by fractional position [fx][fy]:
// (plane1, dx1, dy1, plane2, dx2, dy2), planes 0 = int, 1 = b, 2 = h, 3 = j
__constant__ int8_t kPairs[4][4][6] = {
    {{0, 0, 0, 0, 0, 0}, {0, 0, 0, 2, 0, 0},
     {2, 0, 0, 2, 0, 0}, {2, 0, 0, 0, 0, 1}},
    {{0, 0, 0, 1, 0, 0}, {1, 0, 0, 2, 0, 0},
     {2, 0, 0, 3, 0, 0}, {2, 0, 0, 1, 0, 1}},
    {{1, 0, 0, 1, 0, 0}, {1, 0, 0, 3, 0, 0},
     {3, 0, 0, 3, 0, 0}, {3, 0, 0, 1, 0, 1}},
    {{1, 0, 0, 0, 1, 0}, {1, 0, 0, 2, 1, 0},
     {3, 0, 0, 2, 1, 0}, {2, 1, 0, 1, 0, 1}},
};

struct Smem {
  int32_t raw[4][kWin][kWin + 1];
  int32_t b1[4][kWin][kS];
  int32_t pl[4][4][kS][kS];     // [plane][block][row][col]
  int32_t src[16][16];
  int32_t sad[4][25];
  int32_t win[4];
};

__device__ __forceinline__ int tap6(int a, int b, int c, int d, int e,
                                    int f) {
  return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
}

__device__ __forceinline__ int clip255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

__device__ __forceinline__ void candidate(int c, int sub_lv, int* tx,
                                          int* ty) {
  if (sub_lv == 2) {
    *tx = c % 5 - 2;
    *ty = c / 5 - 2;
  } else if (sub_lv == 1) {
    *tx = 2 * (c % 3) - 2;
    *ty = 2 * (c / 3) - 2;
  } else {
    *tx = 0;
    *ty = 0;
  }
}

// prediction of block q's pixel (r, x) for candidate (tx, ty)
__device__ __forceinline__ int predict(const Smem& s, int q, int r, int x,
                                       int tx, int ty) {
  const int fx = tx & 3, fy = ty & 3;
  const int ix = (tx - fx) >> 2, iy = (ty - fy) >> 2;
  const int8_t* o = kPairs[fx][fy];
  const int a = s.pl[o[0]][q][1 + iy + o[2] + r][1 + ix + o[1] + x];
  const int b = s.pl[o[3]][q][1 + iy + o[5] + r][1 + ix + o[4] + x];
  return (a + b + 1) >> 1;
}

__global__ void __launch_bounds__(kThreads)
partition_refine_mc_kernel(const uint8_t* __restrict__ src,
                           const uint8_t* __restrict__ ref_pad,
                           const int32_t* __restrict__ mv8i,
                           const int32_t* __restrict__ part, int H, int W,
                           int R, int sub_lv, int32_t* __restrict__ mv8,
                           int32_t* __restrict__ pred) {
  __shared__ Smem s;
  const int mbx = blockIdx.x, mby = blockIdx.y;
  const int mbw = gridDim.x;
  const int qw = 2 * mbw;
  const int P = R + 8;
  const int Hp = H + 2 * P, Wp = W + 2 * P;
  const int t = threadIdx.x;

  // ---- raw windows at each block's own vector, and the source MB ----
  for (int i = t; i < 4 * kWin * kWin; i += kThreads) {
    const int q = i / (kWin * kWin);
    const int rc = i - q * kWin * kWin;
    const int r = rc / kWin, c = rc - r * kWin;
    const int by = 2 * mby + (q >> 1), bx = 2 * mbx + (q & 1);
    const int dx = mv8i[2 * (by * qw + bx)];
    const int dy = mv8i[2 * (by * qw + bx) + 1];
    // clamped only for memory safety: with |mv| <= R every read is inside
    const int y = min(max(P + 8 * by + dy - 3 + r, 0), Hp - 1);
    const int x = min(max(P + 8 * bx + dx - 3 + c, 0), Wp - 1);
    s.raw[q][r][c] = ref_pad[(size_t)y * Wp + x];
  }
  for (int i = t; i < 256; i += kThreads) {
    s.src[i >> 4][i & 15] =
        src[(size_t)(16 * mby + (i >> 4)) * W + 16 * mbx + (i & 15)];
  }
  __syncthreads();

  // ---- int, b (and its unrounded intermediate), h ----
  for (int i = t; i < 4 * kWin * kS; i += kThreads) {
    const int q = i / (kWin * kS);
    const int rc = i - q * kWin * kS;
    const int r = rc / kS, c = rc - r * kS;
    const int32_t* w = s.raw[q][r];
    s.b1[q][r][c] = tap6(w[c], w[c + 1], w[c + 2], w[c + 3], w[c + 4],
                         w[c + 5]);
  }
  for (int i = t; i < 4 * kS * kS; i += kThreads) {
    const int q = i / (kS * kS);
    const int rc = i - q * kS * kS;
    const int r = rc / kS, c = rc - r * kS;
    s.pl[0][q][r][c] = s.raw[q][r + 2][c + 2];
    const int h1 = tap6(s.raw[q][r][c + 2], s.raw[q][r + 1][c + 2],
                        s.raw[q][r + 2][c + 2], s.raw[q][r + 3][c + 2],
                        s.raw[q][r + 4][c + 2], s.raw[q][r + 5][c + 2]);
    s.pl[2][q][r][c] = clip255((h1 + 16) >> 5);
  }
  __syncthreads();
  for (int i = t; i < 4 * kS * kS; i += kThreads) {
    const int q = i / (kS * kS);
    const int rc = i - q * kS * kS;
    const int r = rc / kS, c = rc - r * kS;
    s.pl[1][q][r][c] = clip255((s.b1[q][r + 2][c] + 16) >> 5);
    const int j1 = tap6(s.b1[q][r][c], s.b1[q][r + 1][c], s.b1[q][r + 2][c],
                        s.b1[q][r + 3][c], s.b1[q][r + 4][c],
                        s.b1[q][r + 5][c]);
    s.pl[3][q][r][c] = clip255((j1 + 512) >> 10);
  }
  __syncthreads();

  // ---- one thread per (block, candidate): its SAD ----
  const int nc = sub_lv == 2 ? 25 : (sub_lv == 1 ? 9 : 1);
  if (t < 4 * nc) {
    const int q = t / nc, c = t - q * nc;
    int tx, ty;
    candidate(c, sub_lv, &tx, &ty);
    const int oy = 8 * (q >> 1), ox = 8 * (q & 1);
    int sad = 0;
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int x = 0; x < 8; ++x) {
        sad += abs(s.src[oy + r][ox + x] - predict(s, q, r, x, tx, ty));
      }
    }
    s.sad[q][c] = sad;
  }
  __syncthreads();

  // ---- per block: its partition's summed SADs, lexicographic minimum ----
  if (t < 4) {
    const int q = t;
    const int pt = part[mby * mbw + mbx];
    int mask;                           // blocks of q's partition
    if (pt == 0) mask = 0xf;
    else if (pt == 1) mask = 0x3 << (q & 2);
    else if (pt == 2) mask = 0x5 << (q & 1);
    else mask = 1 << q;
    int best = 0, best_cost = 0;
    for (int c = 0; c < nc; ++c) {
      int tx, ty;
      candidate(c, sub_lv, &tx, &ty);
      int sum = 0;
      for (int g = 0; g < 4; ++g) {
        if (mask >> g & 1) sum += s.sad[g][c];
      }
      const int cost = 4 * sum + abs(tx) + abs(ty);
      if (c == 0 || cost < best_cost) {
        best = c;
        best_cost = cost;
      }
    }
    s.win[q] = best;
    int tx, ty;
    candidate(best, sub_lv, &tx, &ty);
    const int by = 2 * mby + (q >> 1), bx = 2 * mbx + (q & 1);
    const int k = 2 * (by * qw + bx);
    mv8[k] = 4 * mv8i[k] + tx;
    mv8[k + 1] = 4 * mv8i[k + 1] + ty;
  }
  __syncthreads();

  // ---- the winner's prediction ----
  for (int i = t; i < 256; i += kThreads) {
    const int y = i >> 4, x = i & 15;
    const int q = 2 * (y >> 3) + (x >> 3);
    int tx, ty;
    candidate(s.win[q], sub_lv, &tx, &ty);
    pred[(size_t)(16 * mby + y) * W + 16 * mbx + x] =
        predict(s, q, y & 7, x & 7, tx, ty);
  }
}

}  // namespace

// Plain C entry for ctypes.  Every pointer is a device pointer; `stream` is
// the caller's cudaStream_t.  Returns cudaGetLastError() after the launch.
extern "C" int x264t_partition_refine_mc(const void* src, const void* ref_pad,
                                         const void* mv8i, const void* part,
                                         int H, int W, int R, int sub_lv,
                                         void* mv8, void* pred,
                                         void* stream) {
  if (H < 16 || W < 16 || H % 16 || W % 16 || R < 1 || R > kMaxR ||
      sub_lv < 0 || sub_lv > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(W / 16, H / 16);
  partition_refine_mc_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(ref_pad),
      static_cast<const int32_t*>(mv8i), static_cast<const int32_t*>(part),
      H, W, R, sub_lv, static_cast<int32_t*>(mv8),
      static_cast<int32_t*>(pred));
  return (int)cudaGetLastError();
}
