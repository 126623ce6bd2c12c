// Masked cohort fold, accumulating in place (FedHeN server hot path).
//
// Replaces the TPU kernel
//   src/repro/kernels/masked_agg/kernel.py::masked_agg_acc_pallas
// (body _agg_acc_kernel), and computes what it computes:
//
//   acc[n] += sum_z gate(x[z, n]) * w[z, n]
//   w[z, n] = mask[n] ? w_m[z] : w_rest[z],  gate(v) = (w > 0) ? v : 0
//
// acc (N,) f32 is updated in place (the reference's input_output_aliases);
// x (Z, N) is f32 or bf16 (the bf16 stream), always accumulated in f32;
// mask (N,) bool; w_m, w_rest (Z,) f32 read from device memory, so the
// round never waits on the host for its weights.
//
// Bound: memory.  The least traffic is Z*N*sizeof(x) + 8N (acc read and
// written) + N (mask) bytes, against 2*Z*N flops — a fraction of a flop
// per byte, far below the card's balance point.  The design therefore reads
// every byte exactly once: a 1-D grid over N, each thread owning 4
// consecutive elements (one 16-byte load per row of f32 x, 8 bytes of
// bf16), acc and mask loaded once into registers, the Z rows folded inside
// the thread in a fixed order (no atomics, so the result is deterministic),
// and acc stored once.  Rows or N that are not 4-aligned take the scalar
// kernel.  The gate is a select: NaN * 0 would be NaN.
//
// Plain C interface, loaded with ctypes (no PyTorch headers, so nvcc
// builds it in seconds).  Each entry point returns the cudaError_t of its
// launch; the wrapper raises on anything but cudaSuccess.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// bf16 is the top half of an f32: widening is a shift, exact.
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}

__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}
__device__ __forceinline__ void load4(const uint16_t* p, float (&o)[4]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  o[0] = __uint_as_float(t.x << 16);  // little-endian: element 0 is low
  o[1] = __uint_as_float(t.x & 0xffff0000u);
  o[2] = __uint_as_float(t.y << 16);
  o[3] = __uint_as_float(t.y & 0xffff0000u);
}

__device__ __forceinline__ float fold1(float s, float xv, bool in_m,
                                       float wm, float wr) {
  const float w = in_m ? wm : wr;
  return fmaf(w > 0.f ? xv : 0.f, w, s);
}

// Requires N % 4 == 0, acc 16-byte, x 4-element and mask 4-byte aligned.
template <typename T>
__global__ void masked_agg_acc_vec4(float* __restrict__ acc,
                                    const T* __restrict__ x,
                                    const uint8_t* __restrict__ mask,
                                    const float* __restrict__ w_m,
                                    const float* __restrict__ w_rest,
                                    int64_t z_rows, int64_t n) {
  const int64_t groups = n >> 2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const int64_t i = g << 2;
    const float4 a = *reinterpret_cast<const float4*>(acc + i);
    const uchar4 m = *reinterpret_cast<const uchar4*>(mask + i);
    float s[4] = {a.x, a.y, a.z, a.w};
    const bool in_m[4] = {m.x != 0, m.y != 0, m.z != 0, m.w != 0};
#pragma unroll 4
    for (int64_t z = 0; z < z_rows; ++z) {
      float xv[4];
      load4(x + z * n + i, xv);
      const float wm = __ldg(w_m + z), wr = __ldg(w_rest + z);
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = fold1(s[j], xv[j], in_m[j], wm, wr);
    }
    *reinterpret_cast<float4*>(acc + i) = make_float4(s[0], s[1], s[2], s[3]);
  }
}

template <typename T>
__global__ void masked_agg_acc_scalar(float* __restrict__ acc,
                                      const T* __restrict__ x,
                                      const uint8_t* __restrict__ mask,
                                      const float* __restrict__ w_m,
                                      const float* __restrict__ w_rest,
                                      int64_t z_rows, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float s = acc[i];
    const bool in_m = mask[i] != 0;
#pragma unroll 4
    for (int64_t z = 0; z < z_rows; ++z)
      s = fold1(s, load1(x + z * n + i), in_m, __ldg(w_m + z),
                __ldg(w_rest + z));
    acc[i] = s;
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;  // grid-stride loops cover the rest

template <typename T>
cudaError_t launch(void* acc, const void* x, const void* mask,
                   const void* w_m, const void* w_rest, int64_t z, int64_t n,
                   int vec4, cudaStream_t stream) {
  const int64_t work = vec4 ? (n >> 2) : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  auto* a = static_cast<float*>(acc);
  auto* xx = static_cast<const T*>(x);
  auto* m = static_cast<const uint8_t*>(mask);
  auto* wm = static_cast<const float*>(w_m);
  auto* wr = static_cast<const float*>(w_rest);
  if (vec4)
    masked_agg_acc_vec4<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(a, xx, m, wm, wr, z, n);
  else
    masked_agg_acc_scalar<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                               stream>>>(a, xx, m, wm, wr, z, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" int masked_agg_acc(void* acc, const void* x, const void* mask,
                              const void* w_m, const void* w_rest,
                              int64_t z, int64_t n, int x_is_bf16, int vec4,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_is_bf16 ? launch<uint16_t>(acc, x, mask, w_m, w_rest, z, n, vec4, s)
                : launch<float>(acc, x, mask, w_m, w_rest, z, n, vec4, s);
  return static_cast<int>(err);
}

extern "C" const char* masked_agg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
