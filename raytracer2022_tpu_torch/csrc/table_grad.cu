// The gradient of a gather from a small table: out[c, t] = sum of grad[c, i]
// over the lanes i with idx[i] == t.
//
// Replaces no TPU kernel.  The JAX package fetched the shading tables' rows
// with one-hot MXU contractions (raytracer2022_tpu/ops/shade.py) and XLA
// differentiated them.  The port fetches them by plain indexing
// (raytracer2022_tpu_torch/ops/shade.py::shade_for_mats), and PyTorch's
// backward of indexing sorts the ids and gives each distinct id one warp,
// which counts its duplicates in a serial loop before it sums them.  A
// fit's wavefront of 524,288 lanes over a table of 4 materials repeats each
// id ~10^5 times, so that backward takes 35.7 ms a launch on an H100, a few
// warps busy while the other SMs idle.  Wrapper, plain version and launch count:
// raytracer2022_tpu_torch/ops/shade.py (table_grad, table_grad_plain,
// TABLE_GRAD_LAUNCHES).
//
// What bounds it on an H100: the bytes, then the launch latency.  A launch
// reads N x C floats of gradient and N 8-byte ids (10.5 MB at N = 524,288
// and C = 3, ~3 us at 3.35 TB/s) and writes C x T floats; the arithmetic is
// a few shuffles a lane.  The design is a deterministic privatised
// reduction:
//   * table_grad_partials: each block takes a fixed contiguous range of
//     lanes, each of its warps a fixed set of 32-lane chunks in it, and each
//     warp keeps private bins for the table (or for one slice of it, the
//     grid's y) in shared memory;
//   * per chunk, __match_any_sync groups the lanes with equal ids; every
//     lane sums its group's gradients in lane order by 32 broadcast
//     shuffles, and the group's leader adds the sum to its warp's bin.
//     Distinct groups have distinct ids and so distinct bins: no atomics;
//   * the block sums its warps' bins in warp order into its row of
//     partials[blocks, C*T];
//   * table_grad_sum: one warp per table entry sums the partials over the
//     blocks, each lane a fixed stride of blocks in block order, then a
//     fixed butterfly.
// Every sum is taken in an order fixed by the shapes and the launch
// configuration, so a launch gives the same bits every time on the same
// card.  No dense (N, T) one-hot is formed.
//
// Layouts: grad f32[C, N] contiguous (C = 1 for a table f32[T]); idx
// i64[N], each in [-T, T) (a negative id counts from the end, as in
// indexing); partials f32[blocks, C*T] scratch; out f32[C, T].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;

// bins: [warps][c_dim][slice] floats of dynamic shared memory.  Block
// (blockIdx.x, blockIdx.y) reads lanes [blockIdx.x * lanes_per_block, +
// lanes_per_block) and bins the ids in [blockIdx.y * slice, + slice).
__global__ void table_grad_partials(const float* __restrict__ grad, const long long* __restrict__ idx,
                                    long long n, int c_dim, int t_dim, int slice, long long lanes_per_block,
                                    float* __restrict__ partials) {
  extern __shared__ float bins[];
  const int warps = blockDim.x / WARP;
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int lo = blockIdx.y * slice;
  const int width = min(slice, t_dim - lo);
  const int per_warp = c_dim * slice;
  for (int j = threadIdx.x; j < warps * per_warp; j += blockDim.x) bins[j] = 0.f;
  __syncthreads();

  float* mine = bins + warp * per_warp;
  const long long start = (long long)blockIdx.x * lanes_per_block;
  const long long end = min(start + lanes_per_block, n);
  for (long long base = start + (long long)warp * WARP; base < end; base += (long long)warps * WARP) {
    const long long i = base + lane;
    int key = -1;  // the lane's bin, -1 when it has none in this slice
    if (i < end) {
      long long id = idx[i];
      if (id < 0) id += t_dim;
      id -= lo;
      if (id >= 0 && id < width) key = (int)id;
    }
    const unsigned group = __match_any_sync(FULL, key);
    const bool leader = key >= 0 && lane == __ffs(group) - 1;
    for (int c = 0; c < c_dim; ++c) {
      const float g = key >= 0 ? grad[(size_t)c * n + i] : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int s = 0; s < WARP; ++s) {
        const float v = __shfl_sync(FULL, g, s);
        if ((group >> s) & 1u) sum += v;
      }
      if (leader) mine[c * slice + key] += sum;
    }
  }
  __syncthreads();

  float* row = partials + (size_t)blockIdx.x * c_dim * t_dim;
  for (int j = threadIdx.x; j < c_dim * width; j += blockDim.x) {
    const int c = j / width, t = j % width;
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += bins[w * per_warp + c * slice + t];
    row[(size_t)c * t_dim + lo + t] = s;
  }
}

// One warp per entry of out[entries]: the sum of partials[b, entry] over b.
__global__ void table_grad_sum(const float* __restrict__ partials, int blocks, int entries,
                               float* __restrict__ out) {
  const int entry = (blockIdx.x * blockDim.x + threadIdx.x) / WARP;
  const int lane = threadIdx.x % WARP;
  if (entry >= entries) return;  // a whole warp: blockDim.x is a multiple of 32
  float s = 0.f;
  for (int b = lane; b < blocks; b += WARP) s += partials[(size_t)b * entries + entry];
#pragma unroll
  for (int off = WARP / 2; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if (lane == 0) out[entry] = s;
}

}  // namespace

// The shared memory a block may opt into on the current device, in bytes
// (-cudaError on a failed query).
extern "C" int rt_table_grad_smem() {
  int dev = 0, bytes = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return e == cudaSuccess ? bytes : -(int)e;
}

// Launches both kernels on stream with the wrapper's plan (blocks x slices
// blocks of warps warps, each warp binning slice entries); returns
// cudaGetLastError() after the launches (0 on success), and the wrapper
// raises on anything else.
extern "C" int rt_table_grad(const float* grad, const long long* idx, long long n, int c_dim, int t_dim,
                             int blocks, int slices, int warps, int slice, long long lanes_per_block,
                             float* partials, float* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || c_dim <= 0 || t_dim <= 0 || blocks <= 0 || warps <= 0 || slice <= 0 ||
      (long long)slices * slice < t_dim)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)warps * c_dim * slice * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(table_grad_partials, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  table_grad_partials<<<dim3(blocks, slices), warps * WARP, smem, stream>>>(grad, idx, n, c_dim, t_dim, slice,
                                                                          lanes_per_block, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int entries = c_dim * t_dim;
  constexpr int SUM_THREADS = 256;
  const long long sum_blocks = ((long long)entries * WARP + SUM_THREADS - 1) / SUM_THREADS;
  table_grad_sum<<<(unsigned)sum_blocks, SUM_THREADS, 0, stream>>>(partials, blocks, entries, out);
  return (int)cudaGetLastError();
}
