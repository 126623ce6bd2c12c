// One-shot masked cohort fold of one leaf (the tree engine's fold).
//
// Replaces the TPU kernel
//   src/repro/kernels/masked_agg/kernel.py::masked_agg_pallas
// (body _agg_kernel), and computes what it computes:
//
//   out[n] = sum_z gate(x[z, n]) * w[z, n]
//   w[z, n] = mask[n] ? w_m[z] : w_rest[z],  gate(v) = (w > 0) ? v : 0
//
// x (Z, N) is f32 or bf16, its rows `ld` elements apart (ld >= N), so a
// leaf can be handed over as a view of the packed (Z, n_flat) chunk buffer
// without a copy; mask (N,) bool; w_m, w_rest (Z,) f32 read from device
// memory; out (N,) in x's dtype, the f32 sum rounded to nearest (even) once
// at the end.  A NaN client at weight 0 is killed by the select gate:
// NaN * 0 would be NaN.
//
// Bound: memory.  The least traffic is Z*N*sizeof(x) + N (mask) +
// N*sizeof(x) (out) bytes against 2*Z*N flops, far below the card's
// balance point.  The design is K1's (masked_agg_acc.cu) without the
// accumulator: a 1-D grid over N, each thread owning 4 consecutive
// elements (one 16-byte load per row of f32 x, 8 bytes of bf16), the mask
// read once, the Z rows folded inside the thread in a fixed order (no
// atomics) and out written once.  A ragged N, a row stride that is not a
// multiple of 4, or a misaligned pointer takes the scalar kernel.  The
// tree engine launches it once per leaf, so at the model's 59 leaves (from
// 1 to 2,359,296 elements) most launches are far too small to fill the
// card: the engine is bound by launches, not by this kernel's bytes.
//
// Each product and each sum is rounded on its own (__fmul_rn, __fadd_rn:
// no FMA contraction), in the plain version's order, starting from 0, so
// the two agree bitwise.
//
// Plain C interface, loaded with ctypes.  The entry point returns the
// cudaError_t of its launch; the wrapper raises on anything but success.

#include <cuda_bf16.h>
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

__device__ __forceinline__ uint16_t to_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(uint16_t* p, float v) {
  *p = to_bf16(v);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(uint16_t* p, const float (&v)[4]) {
  const uint32_t lo = static_cast<uint32_t>(to_bf16(v[0])) |
                      (static_cast<uint32_t>(to_bf16(v[1])) << 16);
  const uint32_t hi = static_cast<uint32_t>(to_bf16(v[2])) |
                      (static_cast<uint32_t>(to_bf16(v[3])) << 16);
  *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
}

__device__ __forceinline__ float fold1(float s, float xv, bool in_m,
                                       float wm, float wr) {
  const float w = in_m ? wm : wr;
  return __fadd_rn(s, __fmul_rn(w > 0.f ? xv : 0.f, w));
}

// Requires N % 4 == 0, ld % 4 == 0, x and out 4-element aligned, mask
// 4-byte aligned.
template <typename T>
__global__ void masked_agg_vec4(T* __restrict__ out, const T* __restrict__ x,
                                const uint8_t* __restrict__ mask,
                                const float* __restrict__ w_m,
                                const float* __restrict__ w_rest,
                                int64_t z_rows, int64_t n, int64_t ld) {
  const int64_t groups = n >> 2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const int64_t i = g << 2;
    const uchar4 m = *reinterpret_cast<const uchar4*>(mask + i);
    const bool in_m[4] = {m.x != 0, m.y != 0, m.z != 0, m.w != 0};
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int64_t z = 0; z < z_rows; ++z) {
      float xv[4];
      load4(x + z * ld + i, xv);
      const float wm = __ldg(w_m + z), wr = __ldg(w_rest + z);
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = fold1(s[j], xv[j], in_m[j], wm, wr);
    }
    store4(out + i, s);
  }
}

template <typename T>
__global__ void masked_agg_scalar(T* __restrict__ out,
                                  const T* __restrict__ x,
                                  const uint8_t* __restrict__ mask,
                                  const float* __restrict__ w_m,
                                  const float* __restrict__ w_rest,
                                  int64_t z_rows, int64_t n, int64_t ld) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float s = 0.f;
    const bool in_m = mask[i] != 0;
#pragma unroll 4
    for (int64_t z = 0; z < z_rows; ++z)
      s = fold1(s, load1(x + z * ld + i), in_m, __ldg(w_m + z),
                __ldg(w_rest + z));
    store1(out + i, s);
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;  // grid-stride loops cover the rest

template <typename T>
cudaError_t launch(void* out, const void* x, const void* mask,
                   const void* w_m, const void* w_rest, int64_t z, int64_t n,
                   int64_t ld, int vec4, cudaStream_t stream) {
  const int64_t work = vec4 ? (n >> 2) : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  auto* o = static_cast<T*>(out);
  auto* xx = static_cast<const T*>(x);
  auto* m = static_cast<const uint8_t*>(mask);
  auto* wm = static_cast<const float*>(w_m);
  auto* wr = static_cast<const float*>(w_rest);
  if (vec4)
    masked_agg_vec4<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(o, xx, m, wm, wr, z, n, ld);
  else
    masked_agg_scalar<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(o, xx, m, wm, wr, z, n, ld);
  return cudaGetLastError();
}

}  // namespace

extern "C" int masked_agg(void* out, const void* x, const void* mask,
                          const void* w_m, const void* w_rest, int64_t z,
                          int64_t n, int64_t ld, int x_is_bf16, int vec4,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_is_bf16
          ? launch<uint16_t>(out, x, mask, w_m, w_rest, z, n, ld, vec4, s)
          : launch<float>(out, x, mask, w_m, w_rest, z, n, ld, vec4, s);
  return static_cast<int>(err);
}
