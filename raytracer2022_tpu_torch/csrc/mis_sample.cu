// The diffuse branch's mixture sample for a whole wavefront (ray_color,
// main.rs:263-266): per lane a cosine-weighted direction about the normal,
// a light sample (a uniform pick over the lights list, then the sphere
// cone or the rect point), a 50/50 pick between the two, and the mixture's
// pdf 0.5 * lights_pdf + 0.5 * cos_pdf (the cosine lobe and its pdf alone
// without lights).
//
// Replaces no TPU kernel.  The JAX package left this block to XLA, which
// fuses it into a few loops (raytracer2022_tpu/render/integrator.py,
// ops/lights.py, ops/sampling.py).  In the port it was ~340-430 PyTorch
// operators a vertex, each a host dispatch of a small elementwise kernel,
// and the largest idle gap of every frame render.  Wrapper, plain version
// and launch count: raytracer2022_tpu_torch/ops/mis.py (mis_sample,
// mis_sample_plain, LAUNCHES).
//
// What bounds it on an H100: the bytes.  A lane reads its point and normal
// (24 B) and k variates (4k B) and writes a direction and a pdf (16 B):
// 60 B at k = 5, 15.7 MB at 261,120 lanes, ~4.7 us at 3.35 TB/s.  The
// arithmetic is a few hundred operations a lane, and a sphere light's hit
// test in double.  The design is one thread per lane over a grid-stride
// loop, loads and stores component-leading (p[c * n + i]) so that a warp's
// accesses coalesce, and the lights list (kind and six parameters a light)
// copied once per block into shared memory, where every lane reads it.
//
// The lane's arithmetic lives in mis_sample.cuh, which vertex.cu shares.
//
// Outputs: new_dir f32[3, n], pdf f32[n] (p, normal f32[3, n]; the
// other layouts are mis_sample.cuh's).

#include "mis_sample.cuh"

namespace {

__global__ void mis_sample_kernel(const float* __restrict__ p, const float* __restrict__ normal,
                                  const float* __restrict__ u, const float* __restrict__ params, long long n_prims,
                                  const int* __restrict__ kind, const int* __restrict__ lights, int n_lights,
                                  long long n, float* __restrict__ new_dir, float* __restrict__ pdf) {
  extern __shared__ float table[];  // [n_lights][LIGHT_WORDS]
  load_light_table(table, params, n_prims, kind, lights, n_lights);
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const V3 pt = {p[i], p[n + i], p[2 * n + i]};
    const V3 nr = {normal[i], normal[n + i], normal[2 * n + i]};
    float pd;
    const V3 d = mis_lane(table, n_lights, pt, nr, u, n, i, &pd);
    new_dir[i] = d.x;
    new_dir[n + i] = d.y;
    new_dir[2 * n + i] = d.z;
    pdf[i] = pd;
  }
}

}  // namespace

// Launches the kernel on stream over blocks blocks of 256 threads; returns
// cudaGetLastError() after the launch (0 on success), and the wrapper
// raises on anything else.  k must be the wrapper's variate rows for
// n_lights; every light a SPHERE or a RECT (the wrapper checks the kinds).
extern "C" int rt_mis_sample(const float* p, const float* normal, const float* u, int k, const float* params,
                             long long n_prims, const int* kind, const int* lights, int n_lights, long long n,
                             int blocks, float* new_dir, float* pdf, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int want = n_lights == 0 ? 2 : (n_lights == 1 ? 5 : 6);
  if (n <= 0 || blocks <= 0 || n_lights < 0 || k != want) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n_lights * LIGHT_WORDS * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  mis_sample_kernel<<<blocks, 256, smem, stream>>>(p, normal, u, params, n_prims, kind, lights, n_lights, n, new_dir,
                                                   pdf);
  return (int)cudaGetLastError();
}
