// Pixel grouping for panoptic fusion: every pixel takes the id of the
// nearest instance center after its predicted offset is added.
//
// Replaces the TPU kernel codeps_tpu/ops/pallas/grouping.py:_grouping_kernel
// (called through group_pixels_pallas). It computes the same function as
// that kernel and as codeps_tpu/ops/panoptic.py:group_pixels:
//
//   id(p) = 1 + argmin_k |(p + offset(p)) - c_k|^2  over the valid centers,
//
// with a strict `<`, so ties go to the lowest k and a NaN distance never
// wins; the running argmin starts at k = 0, as in the JAX versions (a pixel
// whose every distance is NaN or +inf gets id 1); an image without a valid
// center is all 0.
//
// Layout: the offsets are read as two planes (B, 2, H, W), dy then dx,
// which is the instance head's own NCHW output and what the TPU kernel
// reads (off_y_ref, off_x_ref), so neither main path copies them first.
//
// Bound (1x384x1408, K = 200 slots, n valid centers): 12 bytes a pixel
// (two planes in, int32 ids out), 1.94 us at 3.35 TB/s, against 5 FP32
// operations per (pixel, center) pair, 5 * 540,672 * n at 67 TFLOP/s. Up
// to about n = 48 the bytes bound it, above that the operations (2.6 us at
// n = 64, 8.1 us at n = 200). The 67 TFLOP/s counts an FMA as two
// operations, and this kernel cannot use FMA (below); with the running
// argmin its loop issues about 6.7 instructions a pair (time_grouping.py
// --sass), so above a few valid centers the SMs' issue rate, one warp
// instruction per cycle per sub-partition, is the real ceiling, well under
// the published figure. Tensor cores do not apply: the GEMM form
// |l|^2 - 2 l.c + |c|^2 rounds differently from (l_y - c_y)^2 +
// (l_x - c_x)^2, and the argmin has to equal the plain version bit for bit.
//
// Design (each choice timed against its alternatives on an H100 with
// time_grouping.py; numbers in PERF.md):
//   - 2-D tiles: a block of 32 x 8 threads owns 16 rows and 128 columns; a
//     thread owns 4 consecutive pixels in each of 2 rows, read with one
//     16-byte load from each plane and written with one 16-byte store of
//     int32 ids. Coordinates come from the block and thread indices, so no
//     integer division runs per pixel. A scalar path (chosen per launch)
//     covers W % 4 != 0 and an unaligned base; the ragged edges are masked.
//     1 or 4 rows a thread, or 8 pixels a row, were no faster.
//   - The offset loads are issued first, so their latency overlaps the
//     prologue: loading the K centers and flags and compacting the valid
//     ones in order. All warps compact at once: one ballot per 32-slot
//     chunk, then every warp scans the chunk counts with shuffles, and
//     each valid center is written to its slot. Two barriers in all.
//     Kept over a persistent grid (1 or 2 blocks an SM walking row tiles
//     with the next tile's loads in registers), which was slower at every
//     n: the 264 blocks of a 384x1408 image fit in one wave, so every load
//     is already in flight at the start.
//   - The valid centers are walked in groups of kGroup (the last padded
//     with centers at +inf, which never win): per pixel, the group's
//     minimum distance by fminf, then one strict compare-select per group
//     against the running minimum. Once per pixel, at the end, the winning
//     group's kGroup distances are recomputed (bit for bit the same) and
//     the first equal to the minimum gives k. That keeps the first k of
//     the smallest distance, and fminf and the strict `<` both pass over
//     NaN. It cuts the loop from 8.4 to 6.7 instructions a pair (one
//     FMNMX in place of a compare and two selects); groups of 8 were
//     slower at n <= 64, groups of 2 (at 4 rows a thread) from n = 64 up.
//   - One broadcast shared load of two centers feeds 8 independent chains
//     held in registers. The K x H*W distance matrix never exists.
//
// The TPU kernel's tiling limits (W % 128, H % 8, K % 8;
// codeps_tpu/ops/panoptic.py:326-331) do not apply: any B <= 65535, H, W
// and K <= 2048 work.
//
// The distance is written with round-to-nearest intrinsics so nvcc cannot
// contract it into an FMA (an FMA moves near-tie pixels); the result is
// then bit-exact against the plain PyTorch version
// (codeps_torch/ops/grouping.py:group_pixels_plain).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreadsX = 32;      // one warp along a row
constexpr int kThreadsY = 8;       // warps per block
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kPixels = 4;         // consecutive pixels of a row per thread
constexpr int kRows = 2;           // rows per thread, kThreadsY apart
constexpr int kRowsPerBlock = kThreadsY * kRows;
constexpr int kGroup = 4;          // centers per compare-select
constexpr int kMaxCenters = 2048;
constexpr int kMaxRounds = kMaxCenters / kThreads;  // center slots a thread
constexpr int kMaxChunks = kMaxCenters / 32;        // 32-slot ballot chunks

__device__ __forceinline__ float distance(float loc_y, float loc_x,
                                          float2 c) {
  const float ey = __fsub_rn(loc_y, c.x);
  const float ex = __fsub_rn(loc_x, c.y);
  return __fadd_rn(__fmul_rn(ey, ey), __fmul_rn(ex, ex));
}

template <bool kVector>
__global__ void __launch_bounds__(kThreads)
group_pixels_kernel(const float* __restrict__ centers,   // (B, K, 2) y, x
                    const uint8_t* __restrict__ valid,   // (B, K)
                    const float* __restrict__ planes,    // (B, 2, H, W)
                    int32_t* __restrict__ out,           // (B, H, W)
                    int num_centers, int height, int width) {
  // n compacted centers padded to a whole group, then their slots k
  extern __shared__ float4 center_pairs[];
  float2* ctr = reinterpret_cast<float2*>(center_pairs);
  int* slot = reinterpret_cast<int*>(ctr + num_centers + kGroup);
  __shared__ int chunk_count[kMaxChunks];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int b = blockIdx.z;
  const int x0 = (blockIdx.x * kThreadsX + lane) * kPixels;
  const int y0 = blockIdx.y * kRowsPerBlock + warp;
  const int64_t plane = static_cast<int64_t>(height) * width;
  const float* dy_plane = planes + 2 * plane * b;
  const float* dx_plane = dy_plane + plane;
  int32_t* out_plane = out + plane * b;

  // 1. The offsets: loads in flight before anything else.
  float dy[kRows][kPixels], dx[kRows][kPixels];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int y = y0 + r * kThreadsY;
    const int64_t at = static_cast<int64_t>(y) * width + x0;
    if (kVector) {
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), c = a;
      if (y < height && x0 < width) {
        a = *reinterpret_cast<const float4*>(dy_plane + at);
        c = *reinterpret_cast<const float4*>(dx_plane + at);
      }
      dy[r][0] = a.x; dy[r][1] = a.y; dy[r][2] = a.z; dy[r][3] = a.w;
      dx[r][0] = c.x; dx[r][1] = c.y; dx[r][2] = c.z; dx[r][3] = c.w;
    } else {
#pragma unroll
      for (int i = 0; i < kPixels; ++i) {
        const bool in = y < height && x0 + i < width;
        dy[r][i] = in ? dy_plane[at + i] : 0.0f;
        dx[r][i] = in ? dx_plane[at + i] : 0.0f;
      }
    }
  }

  // 2. Order-preserving compaction of the valid centers by all warps.
  // Slot k = round * kThreads + warp * 32 + lane lies in chunk k / 32 =
  // round * kThreadsY + warp, so chunks are numbered in slot order.
  const int64_t img = static_cast<int64_t>(b) * num_centers;
  unsigned ballot[kMaxRounds];
  float2 mine[kMaxRounds];
#pragma unroll
  for (int round = 0; round < kMaxRounds; ++round) {
    ballot[round] = 0u;
    mine[round] = make_float2(0.0f, 0.0f);
    if (round * kThreads < num_centers) {
      const int k = round * kThreads + warp * 32 + lane;
      const bool v = k < num_centers && valid[img + k] != 0;
      if (v) {
        mine[round] = make_float2(centers[2 * (img + k)],
                                  centers[2 * (img + k) + 1]);
      }
      ballot[round] = __ballot_sync(0xffffffffu, v);
      if (lane == 0) {
        chunk_count[round * kThreadsY + warp] = __popc(ballot[round]);
      }
    }
  }
  __syncthreads();
  // Every warp scans the (at most 64) chunk counts itself: lane l holds
  // chunks l and 32 + l.
  const int chunks = (num_centers + kThreads - 1) / kThreads * kThreadsY;
  const int c0 = lane < chunks ? chunk_count[lane] : 0;
  const int c1 = lane + 32 < chunks ? chunk_count[lane + 32] : 0;
  int s0 = c0, s1 = c1;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t0 = __shfl_up_sync(0xffffffffu, s0, d);
    const int t1 = __shfl_up_sync(0xffffffffu, s1, d);
    if (lane >= d) {
      s0 += t0;
      s1 += t1;
    }
  }
  s1 += __shfl_sync(0xffffffffu, s0, 31);
  const int n = __shfl_sync(0xffffffffu, s1, 31);
  const int before0 = s0 - c0, before1 = s1 - c1;  // exclusive prefixes
#pragma unroll
  for (int round = 0; round < kMaxRounds; ++round) {
    if (round * kThreads < num_centers) {
      const int chunk = round * kThreadsY + warp;
      const int p0 = __shfl_sync(0xffffffffu, before0, chunk & 31);
      const int p1 = __shfl_sync(0xffffffffu, before1, chunk & 31);
      if ((ballot[round] >> lane) & 1u) {
        const int pos = (chunk < 32 ? p0 : p1)
                        + __popc(ballot[round] & ((1u << lane) - 1u));
        ctr[pos] = mine[round];
        slot[pos] = round * kThreads + warp * 32 + lane;
      }
    }
  }
  const int tid = warp * kThreadsX + lane;
  if (tid < (kGroup - n % kGroup) % kGroup) {
    ctr[n + tid] = make_float2(CUDART_INF_F, CUDART_INF_F);
  }
  __syncthreads();

  // 3. Running (min, argmin) over the valid centers, a group at a time.
  int id[kRows][kPixels];
  if (n == 0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int i = 0; i < kPixels; ++i) id[r][i] = 0;
    }
  } else {
    float loc_y[kRows][kPixels], loc_x[kRows][kPixels];
    float best[kRows][kPixels];
    int best_g[kRows][kPixels];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float y = static_cast<float>(y0 + r * kThreadsY);
#pragma unroll
      for (int i = 0; i < kPixels; ++i) {
        loc_y[r][i] = __fadd_rn(y, dy[r][i]);
        loc_x[r][i] = __fadd_rn(static_cast<float>(x0 + i), dx[r][i]);
        best[r][i] = CUDART_INF_F;
        best_g[r][i] = -1;
      }
    }
    const int groups = (n + kGroup - 1) / kGroup;
#pragma unroll 1
    for (int g = 0; g < groups; ++g) {
      float2 c[kGroup];
#pragma unroll
      for (int q = 0; q < kGroup; q += 2) {
        const float4 two = center_pairs[(g * kGroup + q) / 2];
        c[q] = make_float2(two.x, two.y);
        c[q + 1] = make_float2(two.z, two.w);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int i = 0; i < kPixels; ++i) {
          float m = distance(loc_y[r][i], loc_x[r][i], c[0]);
#pragma unroll
          for (int q = 1; q < kGroup; ++q) {
            m = fminf(m, distance(loc_y[r][i], loc_x[r][i], c[q]));
          }
          if (m < best[r][i]) {
            best[r][i] = m;
            best_g[r][i] = g;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int i = 0; i < kPixels; ++i) {
        // no win at all (every distance NaN or inf): slot 0, as in JAX
        const int g = best_g[r][i];
        int k = 0;
        if (g >= 0) {
          int first = kGroup - 1;
#pragma unroll
          for (int q = kGroup - 1; q >= 0; --q) {
            if (distance(loc_y[r][i], loc_x[r][i], ctr[g * kGroup + q])
                == best[r][i]) {
              first = q;
            }
          }
          k = slot[g * kGroup + first];
        }
        id[r][i] = k + 1;
      }
    }
  }

  // 4. The ids: one 16-byte store per row, or masked scalar stores.
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int y = y0 + r * kThreadsY;
    if (y >= height) continue;
    int32_t* row = out_plane + static_cast<int64_t>(y) * width;
    if (kVector) {
      if (x0 < width) {
        *reinterpret_cast<int4*>(row + x0) =
            make_int4(id[r][0], id[r][1], id[r][2], id[r][3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kPixels; ++i) {
        if (x0 + i < width) row[x0 + i] = id[r][i];
      }
    }
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int group_pixels_launch(const float* centers, const uint8_t* valid,
                                   const float* planes, int32_t* out,
                                   int batch, int num_centers, int height,
                                   int width, void* stream) {
  if (num_centers < 0 || num_centers > kMaxCenters || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch <= 0 || height <= 0 || width <= 0) return 0;
  const int columns = (width + kPixels - 1) / kPixels;
  const dim3 grid((columns + kThreadsX - 1) / kThreadsX,
                  (height + kRowsPerBlock - 1) / kRowsPerBlock, batch);
  const dim3 block(kThreadsX, kThreadsY);
  const size_t shared = static_cast<size_t>(num_centers + kGroup)
                        * (sizeof(float2) + sizeof(int));
  const bool vector = width % kPixels == 0
                      && reinterpret_cast<uintptr_t>(planes) % 16 == 0
                      && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vector) {
    group_pixels_kernel<true><<<grid, block, shared, s>>>(
        centers, valid, planes, out, num_centers, height, width);
  } else {
    group_pixels_kernel<false><<<grid, block, shared, s>>>(
        centers, valid, planes, out, num_centers, height, width);
  }
  return static_cast<int>(cudaGetLastError());
}
