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
// Bound: memory, at a fraction of a flop per byte.  The least traffic is
// what the weights need: acc read (4N) and the mask (N), row z's x only
// where its weight is live (w > 0), and acc written only where a live row
// changes it.  A complex client is live everywhere (Z*N*sizeof(x) + 9N);
// a simple client weighs 0 off the index set M, so a simple fold needs
// 5N + Z*|M|*sizeof(x) + 4|M|.  On the ResNet's layout |M| is 6 % of N, in
// 15 runs: reading every row everywhere wastes 94 % of a simple fold's x
// bytes, and storing everywhere writes back what it has read.
//
// The design: a 1-D grid over N, each thread owning kGroups groups of 4
// consecutive elements (16 bytes of f32 x, 8 of bf16; a warp's lanes on
// neighbouring groups), acc and mask loaded once into registers, the Z
// rows folded inside the thread in a fixed order (no atomics: the result
// is deterministic).
//  * Row liveness comes from the device weights, never the host: each
//    thread reads row z's two weights (one cached address for the whole
//    grid) and loads x[z] for a group only when some element of the group
//    is live for that row: w_m[z] > 0 for an element in M, w_rest[z] > 0
//    outside -- the gate's own predicate, so a NaN weight is dead.  M
//    comes in long runs, so whole warps agree, and a warp whose lanes all
//    skip a row issues no request for it.
//  * A row not read folds as 0: the gate selects 0 wherever w <= 0, so no
//    bit changes.  Every fold keeps the fmaf chain in row order, dead rows
//    included (fmaf(0, w, s) is s + 0 * w: a -0.0 becomes +0.0, a NaN
//    weight poisons), so the output is bitwise what reading and storing
//    everything gives.
//  * A group is stored only if its bits differ from the acc bits it
//    loaded: bitwise an unconditional store, and off M a simple fold
//    stores nothing.
//  * The loads are predicated, not branched around, and x is widened
//    after them, so Rows<T>::kUnroll rows' loads (bf16: 4) are in flight
//    before the first is used.
// Rows or N that are not 4-aligned take the scalar kernel, which does the
// same one element a thread.  The gate is a select: NaN * 0 would be NaN.
//
// Plain C interface, loaded with ctypes (no PyTorch headers, so nvcc
// builds it in seconds).  Each entry point returns the cudaError_t of its
// launch; the wrapper raises on anything but cudaSuccess.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 2;      // groups of 4 a thread owns (vec4 kernel)
constexpr int64_t kMaxBlocks = 1 << 20;  // grid-stride loops cover the rest

// The rows of x are read once.
template <typename V>
__device__ __forceinline__ V load_once(const V* p) {
  return __ldg(p);
}

// A row's elements as loaded (f32, or bf16 kept as raw bits) and widened
// to f32 after the load.  bf16 is the top half of an f32: widening is a
// shift, exact.
template <typename T>
struct Rows;

// kUnroll: rows whose loads are issued together, enough to keep a
// thread's bytes in flight (a bf16 row brings half an f32 row's).
template <>
struct Rows<float> {
  static constexpr int kUnroll = 1;
  using One = float;
  using Four = float4;
  static __device__ __forceinline__ float widen(float v) { return v; }
  static __device__ __forceinline__ void widen(float4 t, float (&o)[4]) {
    o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
  }
};

template <>
struct Rows<uint16_t> {
  static constexpr int kUnroll = 4;
  using One = uint16_t;
  using Four = uint2;
  static __device__ __forceinline__ float widen(uint16_t v) {
    return __uint_as_float(static_cast<uint32_t>(v) << 16);
  }
  static __device__ __forceinline__ void widen(uint2 t, float (&o)[4]) {
    o[0] = __uint_as_float(t.x << 16);  // little-endian: element 0 is low
    o[1] = __uint_as_float(t.x & 0xffff0000u);
    o[2] = __uint_as_float(t.y << 16);
    o[3] = __uint_as_float(t.y & 0xffff0000u);
  }
};

__device__ __forceinline__ float fold1(float s, float xv, bool in_m,
                                       float wm, float wr) {
  const float w = in_m ? wm : wr;
  return fmaf(w > 0.f ? xv : 0.f, w, s);
}

// Requires N % 4 == 0, acc 16-byte, x 4-element and mask 4-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_agg_acc_vec4(float* __restrict__ acc, const T* __restrict__ x,
                    const uint8_t* __restrict__ mask,
                    const float* __restrict__ w_m,
                    const float* __restrict__ w_rest, int64_t z_rows,
                    int64_t n) {
  using R = Rows<T>;
  using Four = typename R::Four;
  const int lane = threadIdx.x & 31;
  const int64_t groups = n >> 2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x *
                         kGroups;
  // a warp owns 32 * kGroups neighbouring groups a trip, lane l groups
  // base + 32 j
  for (int64_t base = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x - lane) * kGroups + lane;
       base < groups; base += stride) {
    float4 a[kGroups];
    bool in_m[kGroups][4], any_m[kGroups], any_rest[kGroups];
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const int64_t g = base + j * 32;
      uchar4 m = make_uchar4(0, 0, 0, 0);
      a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (g < groups) {
        a[j] = *reinterpret_cast<const float4*>(acc + (g << 2));
        m = __ldg(reinterpret_cast<const uchar4*>(mask + (g << 2)));
      }
      in_m[j][0] = m.x != 0; in_m[j][1] = m.y != 0;
      in_m[j][2] = m.z != 0; in_m[j][3] = m.w != 0;
      any_m[j] = in_m[j][0] || in_m[j][1] || in_m[j][2] || in_m[j][3];
      any_rest[j] = g < groups && !(in_m[j][0] && in_m[j][1] &&
                                    in_m[j][2] && in_m[j][3]);
    }
    float s[kGroups][4];
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      s[j][0] = a[j].x; s[j][1] = a[j].y; s[j][2] = a[j].z; s[j][3] = a[j].w;
    }
#pragma unroll (R::kUnroll)
    for (int64_t z = 0; z < z_rows; ++z) {
      const float wm = __ldg(w_m + z), wr = __ldg(w_rest + z);
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        const bool need = (any_m[j] && wm > 0.f) || (any_rest[j] && wr > 0.f);
        const Four raw = need ? load_once(reinterpret_cast<const Four*>(
                                    x + z * n + ((base + j * 32) << 2)))
                              : Four{};
        float xv[4];     // 0 where the row was not read: gated anyway
        R::widen(raw, xv);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          s[j][k] = fold1(s[j][k], xv[k], in_m[j][k], wm, wr);
      }
    }
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const bool changed =
          __float_as_uint(s[j][0]) != __float_as_uint(a[j].x) ||
          __float_as_uint(s[j][1]) != __float_as_uint(a[j].y) ||
          __float_as_uint(s[j][2]) != __float_as_uint(a[j].z) ||
          __float_as_uint(s[j][3]) != __float_as_uint(a[j].w);
      if (base + j * 32 < groups && changed)
        *reinterpret_cast<float4*>(acc + ((base + j * 32) << 2)) =
            make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
    }
  }
}

// Any N and alignment: one element a thread, the vec4 kernel's skips and
// stores.
template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_agg_acc_scalar(float* __restrict__ acc, const T* __restrict__ x,
                      const uint8_t* __restrict__ mask,
                      const float* __restrict__ w_m,
                      const float* __restrict__ w_rest, int64_t z_rows,
                      int64_t n) {
  using R = Rows<T>;
  using One = typename R::One;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float a = acc[i];
    const bool in_m = mask[i] != 0;
    float s = a;
#pragma unroll (R::kUnroll)
    for (int64_t z = 0; z < z_rows; ++z) {
      const float wm = __ldg(w_m + z), wr = __ldg(w_rest + z);
      const One raw = (in_m ? wm : wr) > 0.f ? load_once(x + z * n + i)
                                             : One{};
      s = fold1(s, R::widen(raw), in_m, wm, wr);
    }
    if (__float_as_uint(s) != __float_as_uint(a)) acc[i] = s;
  }
}

template <typename T>
cudaError_t launch(void* acc, const void* x, const void* mask,
                   const void* w_m, const void* w_rest, int64_t z, int64_t n,
                   int vec4, cudaStream_t stream) {
  auto* a = static_cast<float*>(acc);
  auto* xx = static_cast<const T*>(x);
  auto* m = static_cast<const uint8_t*>(mask);
  auto* wm = static_cast<const float*>(w_m);
  auto* wr = static_cast<const float*>(w_rest);
  const int64_t work = vec4 ? ((n >> 2) + kGroups - 1) / kGroups : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
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
