// Full-search integer motion estimation: best (cost, offset) per partition
// shape, one CTA per macroblock.  Hand-written for Hopper (sm_90a).
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
// v816/k816 (mbh, mbw, 2), v8/k8 (2 mbh, 2 mbw).
//
// What bounds it on an H100: integer instruction issue.  At 1080p with
// R = 16 one call forms 1,089 offsets x 2.09 M pixels = 2.27 G absolute
// byte differences, while the bytes it must move are ~4.9 MB (src 2.1 MB,
// ref_pad 2.2 MB, outputs 0.6 MB): about 460 byte-differences per byte
// read, far past the memory roofline.
//
// What the design does about it:
//   * the source MB (256 B) and its (16 + 2R)^2 reference window (2.3 KB
//     at R = 16) are read from device memory once per CTA into shared
//     memory; every offset is then served from shared memory;
//   * four pixels per instruction: src and candidate rows are packed
//     uint32 words; an unaligned candidate word is two aligned shared
//     loads joined by one __funnelshift_r, and __vsadu4 forms the sum of
//     four absolute differences;
//   * threads split the offsets (thread t takes k = t, t + 256, ...), so
//     a warp reads neighbouring candidate words of the same rows (no bank
//     conflicts) and the source words as broadcasts;
//   * the nine running minima are (cost << 32 | k) in 64-bit registers,
//     so the lexicographic minimum is one unsigned compare; a warp
//     shuffle plus a shared-memory pass finish the CTA.  A minimum does
//     not depend on the order of reduction, so the result is exact and
//     deterministic.
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

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 32;
constexpr int kPlanes = 9;   // 16x16, 16x8 x2, 8x16 x2, 8x8 x4

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

__host__ __device__ inline int window_stride(int R) {
  // bytes per shared window row: word-aligned, plus one spare word so the
  // funnel shift of the last candidate word never reads past the row
  return ((16 + 2 * R + 3) & ~3) + 4;
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    unsigned long long w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w < v ? w : v;
  }
  return v;
}

template <bool kQuad>
__global__ void __launch_bounds__(kThreads)
sad_partition_minima_kernel(const uint8_t* __restrict__ src,
                            const uint8_t* __restrict__ ref_pad, int W,
                            int R, int s0, int s1, int s2, int s3,
                            Outputs out, int32_t* __restrict__ quad) {
  extern __shared__ uint32_t smem[];
  __shared__ unsigned long long red[kPlanes][kWarps];

  const int K = 2 * R + 1;
  const int win = 16 + 2 * R;
  const int stride = window_stride(R);
  const int mbx = blockIdx.x;
  const int mby = blockIdx.y;
  const int mbw = gridDim.x;
  const int Wp = W + 2 * R;

  uint32_t* s_src = smem;                            // 16 rows x 4 words
  uint8_t* s_src8 = reinterpret_cast<uint8_t*>(smem);
  uint8_t* s_win = reinterpret_cast<uint8_t*>(smem + 64);

  for (int i = threadIdx.x; i < 256; i += kThreads) {
    const int r = i >> 4, c = i & 15;
    s_src8[i] = src[(size_t)(16 * mby + r) * W + 16 * mbx + c];
  }
  for (int i = threadIdx.x; i < win * stride; i += kThreads) {
    const int r = i / stride, c = i - r * stride;
    s_win[i] = c < win
        ? ref_pad[(size_t)(16 * mby + r) * Wp + 16 * mbx + c] : 0;
  }
  __syncthreads();

  unsigned long long best[kPlanes];
#pragma unroll
  for (int j = 0; j < kPlanes; ++j) best[j] = ~0ull;

  const int KK = K * K;
  for (int k = threadIdx.x; k < KK; k += kThreads) {
    const int oy = k / K;
    const int ox = k - oy * K;
    const uint32_t pen = (uint32_t)(abs(oy - R) + abs(ox - R));
    const uint32_t sh = 8u * (uint32_t)(ox & 3);
    uint32_t q0 = 0, q1 = 0, q2 = 0, q3 = 0;       // TL, TR, BL, BR
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const uint32_t* row =
          reinterpret_cast<const uint32_t*>(s_win + (oy + r) * stride) +
          (ox >> 2);
      const uint32_t w0 = row[0], w1 = row[1], w2 = row[2], w3 = row[3],
                     w4 = row[4];
      const uint32_t* sr = s_src + 4 * r;
      const uint32_t left = __vsadu4(sr[0], __funnelshift_r(w0, w1, sh)) +
                            __vsadu4(sr[1], __funnelshift_r(w1, w2, sh));
      const uint32_t right = __vsadu4(sr[2], __funnelshift_r(w2, w3, sh)) +
                             __vsadu4(sr[3], __funnelshift_r(w3, w4, sh));
      if (r < 8) {
        q0 += left;
        q1 += right;
      } else {
        q2 += left;
        q3 += right;
      }
    }
    if (kQuad) {
      const int mbh = gridDim.y;
      int32_t* o = quad + ((size_t)k * 2 * mbh + 2 * mby) * (2 * mbw) +
                   2 * mbx;
      o[0] = (int32_t)q0;
      o[1] = (int32_t)q1;
      o[2 * mbw] = (int32_t)q2;
      o[2 * mbw + 1] = (int32_t)q3;
      continue;
    }
    const uint32_t cost[kPlanes] = {
        4u * (q0 + q1 + q2 + q3) + s0 * pen,
        4u * (q0 + q1) + s1 * pen, 4u * (q2 + q3) + s1 * pen,
        4u * (q0 + q2) + s2 * pen, 4u * (q1 + q3) + s2 * pen,
        4u * q0 + s3 * pen, 4u * q1 + s3 * pen,
        4u * q2 + s3 * pen, 4u * q3 + s3 * pen};
#pragma unroll
    for (int j = 0; j < kPlanes; ++j) {
      const unsigned long long p =
          ((unsigned long long)cost[j] << 32) | (unsigned)k;
      best[j] = p < best[j] ? p : best[j];
    }
  }

  if (kQuad) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kPlanes; ++j) {
    const unsigned long long v = warp_min(best[j]);
    if (lane == 0) red[j][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < kPlanes) {
    const int j = threadIdx.x;
    unsigned long long v = red[j][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v = red[j][w] < v ? red[j][w] : v;
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
      const int q = j - 5;
      const int i8 = (2 * mby + (q >> 1)) * (2 * mbw) + 2 * mbx + (q & 1);
      out.v8[i8] = c;
      out.k8[i8] = kk;
    }
  }
}

}  // namespace

// Plain C entry for ctypes.  Every pointer is a device pointer; `stream` is
// the caller's cudaStream_t.  Returns cudaGetLastError() after the launch.
extern "C" int x264t_sad_partition_minima(
    const void* src, const void* ref_pad, int H, int W, int R, int s0,
    int s1, int s2, int s3, void* v16, void* k16, void* v168, void* k168,
    void* v816, void* k816, void* v8, void* k8, void* stream) {
  if (H < 16 || W < 16 || H % 16 || W % 16 || R < 1 || R > kMaxR ||
      s0 < 0 || s1 < 0 || s2 < 0 || s3 < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const Outputs out = {
      static_cast<int32_t*>(v16), static_cast<int32_t*>(k16),
      static_cast<int32_t*>(v168), static_cast<int32_t*>(k168),
      static_cast<int32_t*>(v816), static_cast<int32_t*>(k816),
      static_cast<int32_t*>(v8), static_cast<int32_t*>(k8)};
  const dim3 grid(W / 16, H / 16);
  const size_t smem = 256 + (size_t)(16 + 2 * R) * window_stride(R);
  sad_partition_minima_kernel<false><<<grid, kThreads, smem,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(ref_pad),
      W, R, s0, s1, s2, s3, out, nullptr);
  return (int)cudaGetLastError();
}

// Quad mode: every offset's unreduced quadrant SADs into `quad`
// (K^2, 2H/16, 2W/16) int32.  Returns cudaGetLastError() after the launch.
extern "C" int x264t_sad_search_quad(const void* src, const void* ref_pad,
                                     int H, int W, int R, void* quad,
                                     void* stream) {
  if (H < 16 || W < 16 || H % 16 || W % 16 || R < 1 || R > kMaxR) {
    return (int)cudaErrorInvalidValue;
  }
  const Outputs none = {};
  const dim3 grid(W / 16, H / 16);
  const size_t smem = 256 + (size_t)(16 + 2 * R) * window_stride(R);
  sad_partition_minima_kernel<true><<<grid, kThreads, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<const uint8_t*>(ref_pad),
      W, R, 0, 0, 0, 0, none, static_cast<int32_t*>(quad));
  return (int)cudaGetLastError();
}
