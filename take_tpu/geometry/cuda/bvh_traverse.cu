// CUDA wide-BVH traversal called from JAX through the XLA FFI.
// Build: geometry/bvh_kernel.py composes the nvcc command and loads the
// library; the traversal itself is in bvh_traverse.h.

#include <cuda_runtime.h>

#include <string>

#include "bvh_traverse.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    traverse_kernel(take::TraverseParams p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < p.n_rays) take::traverse_ray(p, i);
}

ffi::Error TraverseImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> ro,
                        ffi::Buffer<ffi::F32> rd, ffi::Buffer<ffi::F32> tmin,
                        ffi::Buffer<ffi::F32> tmax,
                        ffi::Buffer<ffi::F32> node_min,
                        ffi::Buffer<ffi::F32> node_max,
                        ffi::Buffer<ffi::S32> node_child,
                        ffi::Buffer<ffi::S32> node_count,
                        ffi::Buffer<ffi::F32> v0, ffi::Buffer<ffi::F32> e1,
                        ffi::Buffer<ffi::F32> e2,
                        ffi::ResultBuffer<ffi::F32> t_out,
                        ffi::ResultBuffer<ffi::F32> u_out,
                        ffi::ResultBuffer<ffi::F32> v_out,
                        ffi::ResultBuffer<ffi::S32> prim_out,
                        int32_t any_hit) {
  const int64_t n = static_cast<int64_t>(tmin.element_count());
  if (ro.element_count() != 3 * n || rd.element_count() != 3 * n ||
      tmax.element_count() != n || v0.element_count() % 3 != 0 ||
      node_min.element_count() != 3 * node_child.element_count()) {
    return ffi::Error::InvalidArgument("bvh_traverse: inconsistent shapes");
  }
  if (n == 0) return ffi::Error::Success();
  take::TraverseParams p;
  p.ro = ro.typed_data();
  p.rd = rd.typed_data();
  p.tmin = tmin.typed_data();
  p.tmax = tmax.typed_data();
  p.node_min = node_min.typed_data();
  p.node_max = node_max.typed_data();
  p.node_child = node_child.typed_data();
  p.node_count = node_count.typed_data();
  p.v0 = v0.typed_data();
  p.e1 = e1.typed_data();
  p.e2 = e2.typed_data();
  p.n_rays = n;
  p.n_tri_rows = static_cast<int32_t>(v0.element_count() / 3);
  p.any_hit = any_hit;
  p.t_out = t_out->typed_data();
  p.u_out = u_out->typed_data();
  p.v_out = v_out->typed_data();
  p.prim_out = prim_out->typed_data();
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  traverse_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("bvh_traverse launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(TakeBvhTraverse, TraverseImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // ro
                                  .Arg<ffi::Buffer<ffi::F32>>()  // rd
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tmin
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tmax
                                  .Arg<ffi::Buffer<ffi::F32>>()  // node_min
                                  .Arg<ffi::Buffer<ffi::F32>>()  // node_max
                                  .Arg<ffi::Buffer<ffi::S32>>()  // node_child
                                  .Arg<ffi::Buffer<ffi::S32>>()  // node_count
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tri v0
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tri e1
                                  .Arg<ffi::Buffer<ffi::F32>>()  // tri e2
                                  .Ret<ffi::Buffer<ffi::F32>>()  // t
                                  .Ret<ffi::Buffer<ffi::F32>>()  // u
                                  .Ret<ffi::Buffer<ffi::F32>>()  // v
                                  .Ret<ffi::Buffer<ffi::S32>>()  // prim
                                  .Attr<int32_t>("any_hit"));
