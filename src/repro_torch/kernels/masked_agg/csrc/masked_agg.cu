// Masked cohort fold over a table of leaves: the tree engine's whole fold
// in one launch, and the one-shot fold of a single leaf.
//
// Replaces the TPU kernel
//   src/repro/kernels/masked_agg/kernel.py::masked_agg_pallas
// (body _agg_kernel), and computes what it computes, for every leaf l of a
// table (x_off, size, out_off) at once, n in [0, size):
//
//   s[n] = sum_z gate(x[z, x_off + n]) * w[z, out_off + n]   (f32, from 0)
//   w[z, m] = mask[m] ? w_m[z] : w_rest[z],  gate(v) = (w > 0) ? v : 0
//   one-shot:      out[out_off + n] = s[n]            (rounded to x's dtype)
//   accumulating:  acc[out_off + n] = acc[out_off + n] + s[n]   (f32 x)
//
// x (Z, *) is f32 or bf16, its rows `ld` elements apart (a leaf, or the
// whole packed (Z, n_flat) chunk buffer, without a copy); mask bool and
// out / acc are indexed at the same offsets; w_m, w_rest (Z,) f32 are read
// from device memory.  A NaN client at weight 0 is killed by the select
// gate: NaN * 0 would be NaN.
//
// The accumulating form is the tree engine's fold.  The reference runs the
// add in XLA right after its kernel (src/repro/core/aggregate.py:786-789,
// jax.tree.map(jnp.add, state.acc, part)); here it happens in the same
// pass, so a fold of PreActResNet18-GN's 59 leaves is one launch, not 59
// kernel launches, 59 output allocations and 59 adds, and it moves about
// 134 MB less (the adds' read of the part and the acc and their write).
// s is f32 and leaves the one-shot form unrounded for f32 x, so the result
// is bitwise acc.add_(masked_agg(x)).
//
// Bound: memory.  The least traffic is Z*sizeof(x) + 1 (mask) + 8 (acc
// read and written) bytes per element against 2*Z flops, far below the
// card's balance point.  What bounded the per-leaf design was launches:
// most of the 59 leaves (1 to 2,359,296 elements) cannot fill 132 SMs,
// and each launch paid its ramp-up and tail.  So here the work is a list
// of items, (leaf, tile of kTile elements), built once per layout by the
// wrapper and kept on the device (for the one-shot form, the tiles of one
// leaf passed by value), and one launch runs one block per item: the
// card's scheduler balances the small tiles across the SMs, so the ragged
// leaf sizes leave no tail.  In a block each thread owns 4 consecutive
// elements and issues the 16-byte (bf16: 8-byte) loads of up to 8 rows
// before its first add, so every SM keeps its rows' bytes in flight; a
// ragged head or tail (a leaf of 10 elements, a row stride that is not a
// multiple of 4, a misaligned view) takes scalar loads in the same block.
//
// A variant that streamed each item's rows through a shared-memory ring
// with 1-D TMA bulk copies (cp.async.bulk on mbarriers, one producer
// thread, persistent blocks) was slower on the card at every setting
// tried, on the fold and on the largest leaf (PERF.md, section 6).
//
// Each product and each sum is rounded on its own (__fmul_rn, __fadd_rn:
// no FMA contraction), in the plain version's order, so the two agree
// bitwise.
//
// Plain C interface, loaded with ctypes.  The entry point returns the
// cudaError_t of its launch; the wrapper raises on anything but success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 512;                    // elements of one work item
constexpr int kThreads = kTile / 4;           // 4 elements a thread
constexpr int kRowsInFlight = 8;              // rows loaded before the adds

struct Leaf {
  int64_t x_off, size, out_off;
};

struct Args {
  void* out;
  const void* x;
  const uint8_t* mask;
  const float* w_m;
  const float* w_rest;
  const int64_t* leaves;  // (L, 3): x_off, size, out_off; null: `single`
  const int32_t* items;   // (n_items, 2): leaf, tile; null: tiles of `single`
  Leaf single;
  int64_t n_items, z, ld;
};

// Item i: where its tile starts in a row of x and in out / mask, and its
// length (kTile but at a leaf's end).
__device__ __forceinline__ void item_at(const Args& a, int64_t i, int64_t& x0,
                                        int64_t& o0, int& len) {
  Leaf lf = a.single;
  int64_t tile = i;
  if (a.items != nullptr) {
    const int64_t l = __ldg(a.items + 2 * i);
    tile = __ldg(a.items + 2 * i + 1);
    const long long* row =
        reinterpret_cast<const long long*>(a.leaves) + 3 * l;
    lf.x_off = __ldg(row);
    lf.size = __ldg(row + 1);
    lf.out_off = __ldg(row + 2);
  }
  const int64_t e0 = tile * kTile;
  const int64_t rest = lf.size - e0;
  x0 = lf.x_off + e0;
  o0 = lf.out_off + e0;
  len = rest <= 0 ? 0 : (rest < kTile ? static_cast<int>(rest) : kTile);
}

// bf16 is the top half of an f32: widening is a shift, exact.
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}
// Four elements from 16-byte (f32) / 8-byte (bf16) aligned device memory.
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
__device__ __forceinline__ bool store4(float* p, const float (&v)[4]) {
  if (reinterpret_cast<uintptr_t>(p) & 15u) return false;
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  return true;
}
__device__ __forceinline__ bool store4(uint16_t* p, const float (&v)[4]) {
  if (reinterpret_cast<uintptr_t>(p) & 7u) return false;
  const uint32_t lo = static_cast<uint32_t>(to_bf16(v[0])) |
                      (static_cast<uint32_t>(to_bf16(v[1])) << 16);
  const uint32_t hi = static_cast<uint32_t>(to_bf16(v[2])) |
                      (static_cast<uint32_t>(to_bf16(v[3])) << 16);
  *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
  return true;
}

__device__ __forceinline__ float fold1(float s, float xv, bool in_m,
                                       float wm, float wr) {
  const float w = in_m ? wm : wr;
  return __fadd_rn(s, __fmul_rn(w > 0.f ? xv : 0.f, w));
}

template <typename T, bool kAccumulate>
__global__ void __launch_bounds__(kThreads)
    masked_agg_fold_kernel(const Args a) {
  int64_t x0, o0;
  int len;
  item_at(a, blockIdx.x, x0, o0, len);
  const int e = 4 * threadIdx.x;
  const int mine = len - e;  // > 3: all four elements are this item's
  if (mine <= 0) return;
  bool in_m[4] = {false, false, false, false};
  float base[4] = {0.f, 0.f, 0.f, 0.f};
  const uint8_t* m = a.mask + o0 + e;
  if (mine > 3 && !(reinterpret_cast<uintptr_t>(m) & 3u)) {
    const uchar4 t = __ldg(reinterpret_cast<const uchar4*>(m));
    in_m[0] = t.x; in_m[1] = t.y; in_m[2] = t.z; in_m[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < mine) in_m[j] = __ldg(m + j) != 0;
  }
  if (kAccumulate) {  // f32 only
    const float* acc = static_cast<const float*>(a.out) + o0 + e;
    if (mine > 3 && !(reinterpret_cast<uintptr_t>(acc) & 15u)) {
      const float4 t = *reinterpret_cast<const float4*>(acc);
      base[0] = t.x; base[1] = t.y; base[2] = t.z; base[3] = t.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < mine) base[j] = acc[j];
    }
  }
  const T* x = static_cast<const T*>(a.x) + x0 + e;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int64_t z0 = 0; z0 < a.z; z0 += kRowsInFlight) {
    float xv[kRowsInFlight][4];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      xv[u][0] = xv[u][1] = xv[u][2] = xv[u][3] = 0.f;
      if (z0 + u >= a.z) continue;
      const T* row = x + (z0 + u) * a.ld;
      if (mine > 3 &&
          !(reinterpret_cast<uintptr_t>(row) & (4 * sizeof(T) - 1))) {
        load4(row, xv[u]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < mine) xv[u][j] = load1(row + j);
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      if (z0 + u >= a.z) break;
      const float wm = __ldg(a.w_m + z0 + u), wr = __ldg(a.w_rest + z0 + u);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[j] = fold1(s[j], xv[u][j], in_m[j], wm, wr);
    }
  }
  if (kAccumulate) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] = __fadd_rn(base[j], s[j]);
  }
  T* out = static_cast<T*>(a.out) + o0 + e;
  if (mine > 3 && store4(out, s)) return;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < mine) store1(out + j, s[j]);
}

template <typename T, bool kAccumulate>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  masked_agg_fold_kernel<T, kAccumulate>
      <<<static_cast<unsigned>(a.n_items), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// leaves (L, 3) int64 and items (n_items, 2) int32 on the device, or both
// null for the one-shot fold of one leaf of `size` elements (x_off and
// out_off 0).  `tile` must be the kernel's own item length: the wrapper
// builds its item tables with it.
extern "C" int masked_agg_fold(void* out, const void* x, const void* mask,
                               const void* w_m, const void* w_rest,
                               const void* leaves, const void* items,
                               int64_t n_items, int64_t size, int64_t z,
                               int64_t ld, int x_is_bf16, int accumulate,
                               int64_t tile, void* stream) {
  if (tile != kTile || (accumulate && x_is_bf16) ||
      ((leaves == nullptr) != (items == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{out, x, static_cast<const uint8_t*>(mask),
         static_cast<const float*>(w_m), static_cast<const float*>(w_rest),
         static_cast<const int64_t*>(leaves),
         static_cast<const int32_t*>(items), Leaf{0, size, 0}, n_items, z,
         ld};
  if (items == nullptr) a.n_items = (size + kTile - 1) / kTile;
  if (a.n_items <= 0 || z <= 0) return 0;
  if (a.n_items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (accumulate)
    err = launch<float, true>(a, s);
  else if (x_is_bf16)
    err = launch<uint16_t, false>(a, s);
  else
    err = launch<float, false>(a, s);
  return static_cast<int>(err);
}
