// Quarter-pel refinement grouped by partition, plus luma motion
// compensation: one warp per macroblock, a CTA a strip of kWarps
// macroblocks in one MB row.  Hand-written for Hopper (sm_90a).
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
// int32 (8.4 MB) and mv8 (0.3 MB): ~13 MB, 0.004 ms at 3.35 TB/s.  The
// integer work (three 6-tap filters per sample, 25 candidates per pixel)
// is far below the card's instruction rate.  What a design must hide is each
// MB's chain of dependent steps: two global round trips (the vectors,
// then the window), the filters through shared memory, the candidates.
//
// What the design does about it:
//   * one warp per MB and only __syncwarp between its steps, so MBs do not
//     wait on each other; 8,160 warps at 1080p, up to 32 per SM (64
//     registers, 19.5 KB of shared memory per CTA of four);
//   * each block's 14x14 raw window (offsets -3 .. 10 around its vector,
//     read once per lane from mv8i) is loaded as five aligned 32-bit words
//     per row and funnel-shifted into place;
//   * the 6-tap filters run one lane per window row (b) or column (h, j),
//     and their 8-bit results are stored as 8-byte rows at the two column
//     shifts the candidates read (int and h at 1, b and j at 0 and 1);
//   * the candidate loop is unrolled at compile time (sub_lv is a template
//     parameter), so every lane of the warp evaluates the same candidate
//     and its Table 8-12 operands are constants: lane (q, r) forms row r of
//     block q's prediction from two 8-byte loads with __vavgu4 and its SAD
//     with two vabsdiff4; xor-shuffles sum the rows, then the blocks of the
//     MB's partition (the partition is uniform over the warp);
//   * the minimum is one key per candidate, (4*SAD + |tx| + |ty|) << 5 | c,
//     kept in each lane in candidate order with the winner's packed
//     prediction row, which gives the JAX tie order exactly; pred is
//     written as two 16-byte stores per lane;
//   * each 8x8 block gathers its window at its own vector, so a candidate
//     read never uses a neighbour block's vector (the seam rule of the JAX
//     golden model), without the TPU kernel's aligned-variant planes,
//     band stacks, 128-lane padding or cost/index lookup table.

#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

namespace {

constexpr int kWarps = 4;                 // MBs per CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxR = 32;
constexpr int kRaw = 14;                  // raw window: offsets -3 .. 10
constexpr int kB1Stride = 136;            // ints per block of b1 (14 x 9)

// Rows (8 bytes each) of one block's sample planes, in the -1 .. 8 sample
// frame of the block: int at column shift 1 and b at shifts 0 and 1 hold
// sample rows 1 .. 8; h at shift 1 and j at shifts 0 and 1 rows 0 .. 8.
// 56 rows (448 B, 64 mod 128) per block keep the two blocks a half-warp
// reads on disjoint banks.
constexpr int kRowI = 0, kRowB0 = 8, kRowB1 = 16, kRowH = 24, kRowJ0 = 33,
              kRowJ1 = 42, kPlaneRows = 56;

struct WarpSmem {
  uint4 raw[4][kRaw];                     // bytes 0 .. 13 of each row
  int32_t b1[4][kB1Stride];               // unrounded b, [row][column]
  uint2 pl[4][kPlaneRows];
};

struct Operand {
  int plane, dx, dy;    // planes 0 = int, 1 = b, 2 = h, 3 = j
};

struct Pair {
  Operand a, b;
};

// Table 8-12: the two operands of the quarter-pel sample at the fractional
// position (fx, fy), offsets in full pels.
__host__ __device__ constexpr Pair qpel_pair(int fx, int fy) {
  switch (fx << 4 | fy) {
    case 0x00: return {{0, 0, 0}, {0, 0, 0}};
    case 0x01: return {{0, 0, 0}, {2, 0, 0}};
    case 0x02: return {{2, 0, 0}, {2, 0, 0}};
    case 0x03: return {{2, 0, 0}, {0, 0, 1}};
    case 0x10: return {{0, 0, 0}, {1, 0, 0}};
    case 0x11: return {{1, 0, 0}, {2, 0, 0}};
    case 0x12: return {{2, 0, 0}, {3, 0, 0}};
    case 0x13: return {{2, 0, 0}, {1, 0, 1}};
    case 0x20: return {{1, 0, 0}, {1, 0, 0}};
    case 0x21: return {{1, 0, 0}, {3, 0, 0}};
    case 0x22: return {{3, 0, 0}, {3, 0, 0}};
    case 0x23: return {{3, 0, 0}, {1, 0, 1}};
    case 0x30: return {{1, 0, 0}, {0, 1, 0}};
    case 0x31: return {{1, 0, 0}, {2, 1, 0}};
    case 0x32: return {{3, 0, 0}, {2, 1, 0}};
    case 0x33: return {{2, 1, 0}, {1, 0, 1}};
  }
  return {{-1, 0, 0}, {-1, 0, 0}};
}

// The stored row that lane row 0 reads for an operand of a candidate with
// integer part (ix, iy); -1 where no stored row holds it.
__host__ __device__ constexpr int plane_row(Operand o, int ix, int iy) {
  const int cs = 1 + ix + o.dx;           // first sample column
  const int rs = 1 + iy + o.dy;           // first sample row
  const bool c01 = cs == 0 || cs == 1, r01 = rs == 0 || rs == 1;
  switch (o.plane) {
    case 0: return cs == 1 && rs == 1 ? kRowI : -1;
    case 1: return c01 && rs == 1 ? (cs ? kRowB1 : kRowB0) : -1;
    case 2: return cs == 1 && r01 ? kRowH + rs : -1;
    case 3: return c01 && r01 ? (cs ? kRowJ1 : kRowJ0) + rs : -1;
  }
  return -1;
}

__host__ __device__ constexpr int iabs(int v) { return v < 0 ? -v : v; }

__host__ __device__ constexpr int cand_tx(int sub_lv, int c) {
  return sub_lv == 2 ? c % 5 - 2 : (sub_lv == 1 ? 2 * (c % 3) - 2 : 0);
}

__host__ __device__ constexpr int cand_ty(int sub_lv, int c) {
  return sub_lv == 2 ? c / 5 - 2 : (sub_lv == 1 ? 2 * (c / 3) - 2 : 0);
}

struct Cand {
  int row_a, row_b;   // stored rows of the two operands (lane row 0)
  uint32_t tail;      // (|tx| + |ty|) << 5 | c: the key is SAD * 128 + tail
};

template <int kSub>
__host__ __device__ constexpr Cand candidate(int c) {
  const int tx = cand_tx(kSub, c), ty = cand_ty(kSub, c);
  const int fx = tx & 3, fy = ty & 3;
  const int ix = (tx - fx) / 4, iy = (ty - fy) / 4;
  const Pair p = qpel_pair(fx, fy);
  return {plane_row(p.a, ix, iy), plane_row(p.b, ix, iy),
          (uint32_t)((iabs(tx) + iabs(ty)) << 5 | c)};
}

template <typename F, int... C>
__device__ __forceinline__ void for_each(F&& f,
                                         std::integer_sequence<int, C...>) {
  (f(std::integral_constant<int, C>{}), ...);
}

__device__ __forceinline__ int tap6(int a, int b, int c, int d, int e,
                                    int f) {
  return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
}

__device__ __forceinline__ uint32_t clip255(int v) {
  return (uint32_t)min(max(v, 0), 255);
}

__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return a | b << 8 | c << 16 | d << 24;
}

// acc + the sum of the four absolute byte differences of a and b
__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b,
                                         uint32_t acc) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d) : "r"(a), "r"(b), "r"(acc));
  return d;
}

template <int kSub>
__global__ void __launch_bounds__(kThreads, 8)
partition_refine_mc_kernel(const uint8_t* __restrict__ src,
                           const uint8_t* __restrict__ ref_pad,
                           const int32_t* __restrict__ mv8i,
                           const int32_t* __restrict__ part, int W, int R,
                           int32_t* __restrict__ mv8,
                           int32_t* __restrict__ pred) {
  constexpr int kNC = kSub == 2 ? 25 : (kSub == 1 ? 9 : 1);
  __shared__ WarpSmem smem[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mbw = W >> 4;
  const int mbx = blockIdx.x * kWarps + warp, mby = blockIdx.y;
  if (mbx >= mbw) return;                 // the whole warp: no CTA barrier
  WarpSmem& s = smem[warp];
  const int q = lane >> 3, r = lane & 7;  // block (TL, TR, BL, BR), row
  const int P = R + 8, Wp = W + 2 * P;
  const int by = 2 * mby + (q >> 1), bx = 2 * mbx + (q & 1);
  const int mi = 2 * (by * 2 * mbw + bx);
  const int mx = __ldg(mv8i + mi), my = __ldg(mv8i + mi + 1);
  // clamped for memory safety only: the contract keeps |mv| <= R
  const int cx = min(max(mx, -R), R), cy = min(max(my, -R), R);

  // ---- the lane's source row: row r of block q --------------------------
  const uint8_t* srow = src + (size_t)(8 * by + r) * W + 8 * bx;
  uint32_t s0 = 0, s1 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 7) == 0) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(srow));
    s0 = v.x;
    s1 = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s0 |= (uint32_t)__ldg(srow + i) << (8 * i);
      s1 |= (uint32_t)__ldg(srow + 4 + i) << (8 * i);
    }
  }

  // ---- raw windows: 4 blocks x 14 rows, a lane per row ------------------
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = lane + 32 * k;
    const int g = min(i / kRaw, 3), rr = i - g * kRaw;
    const int gx = __shfl_sync(~0u, cx, 8 * g);
    const int gy = __shfl_sync(~0u, cy, 8 * g);
    if (i < 4 * kRaw) {
      const int gby = 2 * mby + (g >> 1), gbx = 2 * mbx + (g & 1);
      const uintptr_t a = reinterpret_cast<uintptr_t>(
          ref_pad + (size_t)(P + 8 * gby + gy - 3 + rr) * Wp +
          (P + 8 * gbx + gx - 3));
      // five aligned words cover the 14 bytes; with |mv| <= R they lie
      // inside ref_pad
      const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3);
      const int sh = 8 * (int)(a & 3);
      uint32_t v[5];
#pragma unroll
      for (int u = 0; u < 5; ++u) v[u] = __ldg(w + u);
      s.raw[g][rr] = make_uint4(__funnelshift_r(v[0], v[1], sh),
                                __funnelshift_r(v[1], v[2], sh),
                                __funnelshift_r(v[2], v[3], sh),
                                __funnelshift_r(v[3], v[4], sh));
    }
  }
  __syncwarp();

  uint32_t p0, p1;                        // the winner's prediction row
  if constexpr (kSub == 0) {
    // one candidate, (0, 0): integer-pel MC
    const uint4 w = s.raw[q][r + 3];
    p0 = __byte_perm(w.x, w.y, 0x6543);
    p1 = __byte_perm(w.y, w.z, 0x6543);
  } else {
    // ---- b (and its unrounded b1) and int: a lane per raw row ----------
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = lane + 32 * k;
      if (i < 4 * kRaw) {
        const int g = i / kRaw, rr = i - g * kRaw;
        const uint4 w = s.raw[g][rr];
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
        int v[kRaw];
#pragma unroll
        for (int j = 0; j < kRaw; ++j) {
          v[j] = (words[j >> 2] >> (8 * (j & 3))) & 255;
        }
        int b1[9];
#pragma unroll
        for (int c = 0; c < 9; ++c) {
          b1[c] = tap6(v[c], v[c + 1], v[c + 2], v[c + 3], v[c + 4], v[c + 5]);
          s.b1[g][9 * rr + c] = b1[c];
        }
        if (rr >= 3 && rr <= 10) {        // sample rows 1 .. 8
          uint32_t b[9];
#pragma unroll
          for (int c = 0; c < 9; ++c) b[c] = clip255((b1[c] + 16) >> 5);
          s.pl[g][kRowB0 + rr - 3] = make_uint2(pack4(b[0], b[1], b[2], b[3]),
                                                pack4(b[4], b[5], b[6], b[7]));
          s.pl[g][kRowB1 + rr - 3] = make_uint2(pack4(b[1], b[2], b[3], b[4]),
                                                pack4(b[5], b[6], b[7], b[8]));
          s.pl[g][kRowI + rr - 3] = make_uint2(__byte_perm(w.x, w.y, 0x6543),
                                               __byte_perm(w.y, w.z, 0x6543));
        }
      }
    }
    // ---- h: lane (q, c) takes sample column 1 + c (raw column c + 3) ----
    {
      const uint8_t* col = reinterpret_cast<const uint8_t*>(s.raw[q]) + r + 3;
      int v[kRaw];
#pragma unroll
      for (int rr = 0; rr < kRaw; ++rr) v[rr] = col[16 * rr];
      uint8_t* h = reinterpret_cast<uint8_t*>(&s.pl[q][kRowH]) + r;
#pragma unroll
      for (int sr = 0; sr < 9; ++sr) {
        h[8 * sr] = (uint8_t)clip255(
            (tap6(v[sr], v[sr + 1], v[sr + 2], v[sr + 3], v[sr + 4], v[sr + 5])
             + 16) >> 5);
      }
    }
    __syncwarp();
    // ---- j from b1: lane (q, c) takes sample column c, and of column 8
    //      sample row c (lane 0 also row 8) --------------------------------
    {
      const int32_t* col = s.b1[q] + r;
      int v[kRaw];
#pragma unroll
      for (int rr = 0; rr < kRaw; ++rr) v[rr] = col[9 * rr];
      uint8_t* j0 = reinterpret_cast<uint8_t*>(&s.pl[q][kRowJ0]) + r;
      uint8_t* j1 = reinterpret_cast<uint8_t*>(&s.pl[q][kRowJ1]) + r - 1;
#pragma unroll
      for (int sr = 0; sr < 9; ++sr) {
        const uint8_t j = (uint8_t)clip255(
            (tap6(v[sr], v[sr + 1], v[sr + 2], v[sr + 3], v[sr + 4], v[sr + 5])
             + 512) >> 10);
        j0[8 * sr] = j;
        if (r) j1[8 * sr] = j;
      }
      const int32_t* c8 = s.b1[q] + 8;
      uint8_t* j18 = reinterpret_cast<uint8_t*>(&s.pl[q][kRowJ1]) + 7;
      for (int sr = r; sr < 9; sr += 8) {
        j18[8 * sr] = (uint8_t)clip255(
            (tap6(c8[9 * sr], c8[9 * (sr + 1)], c8[9 * (sr + 2)],
                  c8[9 * (sr + 3)], c8[9 * (sr + 4)], c8[9 * (sr + 5)])
             + 512) >> 10);
      }
    }
    __syncwarp();

    // ---- every candidate, the same one in every lane -------------------
    const int pt = __ldg(part + mby * mbw + mbx);       // uniform
    const uint32_t m8 = pt == 0 || pt == 1 ? ~0u : 0u;   // + block beside
    const uint32_t m16 = pt == 0 || pt == 2 ? ~0u : 0u;  // + block below
    const uint2* pl = s.pl[q] + r;
    uint32_t best = ~0u;
    p0 = 0;
    p1 = 0;
    for_each(
        [&](auto ic) {
          constexpr Cand k = candidate<kSub>(decltype(ic)::value);
          static_assert(k.row_a >= 0 && k.row_b >= 0, "operand not stored");
          const uint2 a = pl[k.row_a];
          uint32_t x0 = a.x, x1 = a.y;
          if constexpr (k.row_b != k.row_a) {
            const uint2 b = pl[k.row_b];
            x0 = __vavgu4(x0, b.x);
            x1 = __vavgu4(x1, b.y);
          }
          uint32_t sad = sad4(s1, x1, sad4(s0, x0, 0));
          sad += __shfl_xor_sync(~0u, sad, 1);
          sad += __shfl_xor_sync(~0u, sad, 2);
          sad += __shfl_xor_sync(~0u, sad, 4);
          sad += __shfl_xor_sync(~0u, sad, 8) & m8;
          sad += __shfl_xor_sync(~0u, sad, 16) & m16;
          const uint32_t key = sad * 128u + k.tail;
          if (key < best) {
            best = key;
            p0 = x0;
            p1 = x1;
          }
        },
        std::make_integer_sequence<int, kNC>{});
    if (r == 0) {
      const int c = (int)(best & 31u);
      *reinterpret_cast<int2*>(mv8 + mi) =
          make_int2(4 * mx + cand_tx(kSub, c), 4 * my + cand_ty(kSub, c));
    }
  }
  if constexpr (kSub == 0) {
    if (r == 0) *reinterpret_cast<int2*>(mv8 + mi) = make_int2(4 * mx, 4 * my);
  }

  // ---- the winner's prediction row: 8 int32, two 16-byte stores ---------
  int4* out =
      reinterpret_cast<int4*>(pred + (size_t)(8 * by + r) * W + 8 * bx);
  out[0] = make_int4(__byte_perm(p0, 0, 0x4440), __byte_perm(p0, 0, 0x4441),
                     __byte_perm(p0, 0, 0x4442), __byte_perm(p0, 0, 0x4443));
  out[1] = make_int4(__byte_perm(p1, 0, 0x4440), __byte_perm(p1, 0, 0x4441),
                     __byte_perm(p1, 0, 0x4442), __byte_perm(p1, 0, 0x4443));
}

template <int kSub>
int launch(const void* src, const void* ref_pad, const void* mv8i,
           const void* part, int H, int W, int R, void* mv8, void* pred,
           void* stream) {
  const dim3 grid((W / 16 + kWarps - 1) / kWarps, H / 16);
  partition_refine_mc_kernel<kSub><<<grid, kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(ref_pad),
      static_cast<const int32_t*>(mv8i), static_cast<const int32_t*>(part), W,
      R, static_cast<int32_t*>(mv8), static_cast<int32_t*>(pred));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes.  Every pointer is a device pointer; mv8 must be
// 8-byte and pred 16-byte aligned (fresh torch allocations are).  `stream`
// is the caller's cudaStream_t.  Returns cudaGetLastError() after the
// launch.
extern "C" int x264t_partition_refine_mc(const void* src, const void* ref_pad,
                                         const void* mv8i, const void* part,
                                         int H, int W, int R, int sub_lv,
                                         void* mv8, void* pred,
                                         void* stream) {
  if (H < 16 || W < 16 || H % 16 || W % 16 || R < 1 || R > kMaxR ||
      sub_lv < 0 || sub_lv > 2 || (reinterpret_cast<uintptr_t>(mv8) & 7) ||
      (reinterpret_cast<uintptr_t>(pred) & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  if (sub_lv == 2) {
    return launch<2>(src, ref_pad, mv8i, part, H, W, R, mv8, pred, stream);
  }
  if (sub_lv == 1) {
    return launch<1>(src, ref_pad, mv8i, part, H, W, R, mv8, pred, stream);
  }
  return launch<0>(src, ref_pad, mv8i, part, H, W, R, mv8, pred, stream);
}
