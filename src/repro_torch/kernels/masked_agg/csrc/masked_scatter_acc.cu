// Masked scatter fold of top-k uploads, accumulating in place.
//
// Replaces the TPU kernel
//   src/repro/kernels/masked_agg/kernel.py::masked_scatter_acc_pallas
// (body _make_scatter_acc_kernel), and computes what it computes:
//
//   for z in 0..Z-1 (in order), skipping rows with w_m[z] <= 0 and
//   w_rest[z] <= 0:
//     for j in 0..k-1:  p = idx[z, j];  w = mask[p] ? w_m[z] : w_rest[z]
//       acc[p] += (w > 0 ? v[z, j] * s[z, j / qb] : 0) * w
//
// acc (N,) f32 is updated in place; v (Z, k) int8, bf16 or f32; s (Z,
// k / qb) f32 scales, or none (bf16/f32 payloads); idx (Z, k) int32 with
// each row's indices distinct, sorted ascending and inside [0, N) (what
// comm.sparse_encode ships); mask (N,) bool; w_m, w_rest (Z,) f32 read
// from device memory.
//
// Bound: memory, at the card's 32-byte sector.  Each kept entry needs its
// value, index and scale, and the acc and mask sectors its position falls
// in; at the complex population's density (each row 7.14 % of positions)
// the rows' union touches most sectors of acc, so acc is read and written
// nearly whole, against a few flops per entry.
//
// Design.  The TPU has no lane scatter, so its kernel builds a
// (k_tile, block_n) one-hot and contracts it on the matrix unit for every
// grid block.  Hopper scatters directly, so none of that is carried over.
// Indices are distinct within a row, so a row needs no atomics; they
// collide across rows, and atomics there would reorder the f32 adds (the
// reference adds row after row, as .at[].add does).  So one block at a
// time owns a span of acc and applies the rows to it in z order.  What
// held the earlier design back was latency, not bytes: every block ran Z
// serial binary searches (about 20 dependent loads each) before any work,
// then chased idx -> mask -> acc in device memory row by row with a
// barrier between rows, and every span paid that, entries or not.  Here,
// after one memset of the scratch, in two launches:
//
// 1. scatter_bounds, four entries of a live row (one whose two weights
//    are not both 0) a thread: the entry that opens its row's run in a
//    span writes the run's start, the one that closes it the run's end,
//    and the first entry of any row in a span appends the span to a list
//    of live spans (an atomic flag and counter).  Every other (row, span)
//    keeps the memset's empty run [0, 0).
// 2. scatter_apply, persistent blocks walking the live spans only (the
//    simple population's entries all lie in M, a few spans of the model).
//    A block issues the loads of its span's entries (index, value and
//    scale, eight a thread, none waiting on another) and the cp.async
//    copies of its span of acc and mask into shared memory, stages the
//    entries dequantized in shared memory, then applies them in z order
//    to the shared copy, one barrier per row at shared-memory latency,
//    and writes the span back with 16-byte stores.  The runs of the
//    block's next span are loaded while this one is applied.  Entries
//    beyond the staging room are taken in further rounds, still in z
//    order.  Spans of 4096 positions and 256 threads a block were the
//    fastest of the sizes tried on the card.
//
// A position belongs to one span and a span to one block, so the result is
// deterministic and in the reference's order.  An entry outside its
// block's span (only possible when the index contract is broken) is
// dropped, and runs are clamped to [0, k], so a broken contract gives a
// wrong sum, never an access out of bounds.  Products and sums are rounded
// one by one (__fmul_rn, __fadd_rn), in the plain version's order, so the
// two agree bitwise.
//
// Plain C interface, loaded with ctypes.  The entry point returns the
// cudaError_t of its launches; the wrapper raises on anything but success.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStage = 2048;     // entries staged in shared memory at a time
constexpr int kMaxSpan = 4096;   // acc positions owned by one block
constexpr int kMinSpan = 1024;
constexpr int kMaxRows = 6144;
constexpr int kBoundsPer = 4;    // entries a thread of scatter_bounds takes

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {  // bf16: exact
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
__device__ __forceinline__ float widen(int8_t v) {
  return static_cast<float>(v);
}

__device__ __forceinline__ bool live_row(const float* w_m, const float* w_rest,
                                         int32_t z) {
  return __ldg(w_m + z) > 0.f || __ldg(w_rest + z) > 0.f;
}

// The span of position p (span = 1 << log2_span), with positions outside
// [0, n) (a broken index contract) put in the first span or past the last.
__device__ __forceinline__ int32_t span_of(int32_t p, int64_t n,
                                           int log2_span, int32_t n_spans) {
  return p < 0 ? 0 : (p >= n ? n_spans : p >> log2_span);
}

// The scratch, int32, zeroed before scatter_bounds: start, end (Z,
// n_spans): row z's entries in span s are [start, end); live (n_spans,):
// span s has an entry of a live row; count: how many; list (n_spans,):
// the live spans plus one, in no order, then 0.
struct Scratch {
  int32_t *start, *end, *live, *count, *list;
};
__host__ __device__ inline Scratch scratch_at(int32_t* base, int32_t z,
                                              int64_t n_spans) {
  const int64_t rows = static_cast<int64_t>(z) * n_spans;
  return {base, base + rows, base + 2 * rows, base + 2 * rows + n_spans,
          base + 2 * rows + n_spans + 1};
}

// Grid (x, Z): row blockIdx.y; each thread takes kBoundsPer consecutive
// entries (16-byte loads when the rows are 16-byte aligned), all loaded
// before any is looked at, and the spans of their two neighbours.
__global__ void scatter_bounds(const int32_t* __restrict__ idx,
                               const float* __restrict__ w_m,
                               const float* __restrict__ w_rest, Scratch sc,
                               int32_t k, int64_t n, int log2_span,
                               int32_t n_spans, int vec) {
  const int32_t z = blockIdx.y;
  if (!live_row(w_m, w_rest, z)) return;
  const int32_t j0 = kBoundsPer * (blockIdx.x * blockDim.x + threadIdx.x);
  if (j0 >= k) return;
  const int32_t* row = idx + static_cast<int64_t>(z) * k;
  // p[0] the predecessor, p[1..kBoundsPer] the entries, then the
  // successor; sp their spans, n_spans past the row's end, so its last
  // entry closes its run
  int32_t p[kBoundsPer + 2];
  p[0] = j0 == 0 ? 0 : __ldg(row + j0 - 1);
  if (vec && j0 + kBoundsPer <= k) {
#pragma unroll
    for (int q = 0; q < kBoundsPer / 4; ++q) {
      const int4 t = __ldg(reinterpret_cast<const int4*>(row + j0) + q);
      p[4 * q + 1] = t.x;
      p[4 * q + 2] = t.y;
      p[4 * q + 3] = t.z;
      p[4 * q + 4] = t.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < kBoundsPer; ++u)
      p[u + 1] = j0 + u < k ? __ldg(row + j0 + u) : 0;
  }
  p[kBoundsPer + 1] = j0 + kBoundsPer < k ? __ldg(row + j0 + kBoundsPer) : 0;
  int32_t sp[kBoundsPer + 2];
#pragma unroll
  for (int u = 0; u < kBoundsPer + 2; ++u)
    sp[u] = j0 + u - 1 < k ? span_of(p[u], n, log2_span, n_spans) : n_spans;
  if (j0 == 0) sp[0] = -1;
  int32_t* start = sc.start + static_cast<int64_t>(z) * n_spans;
  int32_t* end = sc.end + static_cast<int64_t>(z) * n_spans;
#pragma unroll
  for (int u = 1; u <= kBoundsPer; ++u) {
    const int32_t here = sp[u], j = j0 + u - 1;
    if (here >= n_spans) continue;  // past the row's end, or past n
    if (here != sp[u + 1]) end[here] = j + 1;
    if (here != sp[u - 1]) {
      start[here] = j;
      if (atomicExch(sc.live + here, 1) == 0)
        sc.list[atomicAdd(sc.count, 1)] = here + 1;
    }
  }
}

// Dynamic shared memory of scatter_apply, in this order: acc span (f32),
// staged indices (int32), staged values (f32), mask span (bytes), then per
// row its run's start, the rows' exclusive prefix of entry counts (int32,
// Z and Z + 1) and the two weights (f32, 2 Z).  Every part starts 16-byte
// aligned but the last three.
__host__ __device__ constexpr size_t apply_smem(int64_t span, int32_t z) {
  return static_cast<size_t>(span) * 5 + kStage * 8 +
         static_cast<size_t>(4 * z + 1) * 4;
}

// Exclusive prefix sum, in place, of the counts in off[0..z): off[r]
// becomes the count of rows before r, off[z] the total.  Each thread sums
// a run of rows, then the threads' totals are scanned.
__device__ void block_prefix(int32_t* off, int32_t z) {
  __shared__ int32_t warp_sums[kThreads / 32];
  const int per = (z + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * per;
  const int hi = lo + per < z ? lo + per : z;
  int32_t mine = 0;
  for (int r = lo; r < hi; ++r) mine += off[r];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t t = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int32_t run = incl - mine;
  for (int w = 0; w < warp; ++w) run += warp_sums[w];
  for (int r = lo; r < hi; ++r) {  // this thread's rows only
    const int32_t c = off[r];
    off[r] = run;
    run += c;
  }
  if (threadIdx.x == kThreads - 1) off[z] = run;
  __syncthreads();
}

// Row of staged entry g: the last r with off[r] <= g (rows [0, z)).
__device__ __forceinline__ int32_t row_of(const int32_t* off, int32_t z,
                                          int32_t g) {
  int32_t lo = 0, hi = z - 1;
  while (lo < hi) {
    const int32_t mid = (lo + hi + 1) >> 1;
    if (off[mid] <= g) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Row z's run in span s as the scratch holds it: (start, end).
__device__ __forceinline__ int2 run_of(const Scratch& sc, int64_t n_spans,
                                       int32_t z, int64_t s) {
  const int64_t at = static_cast<int64_t>(z) * n_spans + s;
  return make_int2(sc.start[at], sc.end[at]);
}
// Row z's run into shared memory, clamped to [0, k]: start and count.
__device__ __forceinline__ void put_run(int32_t* s_lo, int32_t* s_off,
                                        int32_t z, int2 r, int32_t k) {
  const int32_t lo = r.x < 0 ? 0 : (r.x > k ? k : r.x);
  const int32_t hi = r.y < lo ? lo : (r.y > k ? k : r.y);
  s_lo[z] = lo;
  s_off[z] = hi - lo;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Persistent blocks over the live spans, i = blockIdx.x + t * gridDim.x.
// While span i is applied, the runs of the block's next span are on their
// way, so a span's chain of dependent loads is one step: its entries and
// its acc and mask, issued together, entries first.
template <typename V, bool kScales>
__global__ void __launch_bounds__(kThreads)
    scatter_apply(float* __restrict__ acc, const V* __restrict__ values,
                  const float* __restrict__ scales,
                  const int32_t* __restrict__ idx,
                  const uint8_t* __restrict__ mask,
                  const float* __restrict__ w_m,
                  const float* __restrict__ w_rest, const Scratch sc,
                  int32_t z_rows, int32_t k, int64_t n, int log2_qb,
                  int64_t span, int64_t n_spans, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_acc = reinterpret_cast<float*>(smem);
  int32_t* s_pos = reinterpret_cast<int32_t*>(s_acc + span);
  float* s_val = reinterpret_cast<float*>(s_pos + kStage);
  uint8_t* s_mask = reinterpret_cast<uint8_t*>(s_val + kStage);
  int32_t* s_lo = reinterpret_cast<int32_t*>(s_mask + span);
  int32_t* s_off = s_lo + z_rows;
  float* s_wm = reinterpret_cast<float*>(s_off + z_rows + 1);
  float* s_wr = s_wm + z_rows;
  const int32_t k_scales = k >> log2_qb;
  const int64_t first = blockIdx.x, stride = gridDim.x;
  // the block's spans: list[first + t * stride] - 1 until that is -1
  const auto span_at = [&](int64_t i) -> int64_t {
    return i < n_spans ? static_cast<int64_t>(sc.list[i]) - 1 : -1;
  };
  int64_t s = span_at(first);
  if (s < 0) return;
  int64_t s_next = span_at(first + stride);
  for (int32_t z = threadIdx.x; z < z_rows; z += kThreads) {
    s_wm[z] = __ldg(w_m + z);
    s_wr[z] = __ldg(w_rest + z);
    put_run(s_lo, s_off, z, run_of(sc, n_spans, z, s), k);
  }
  __syncthreads();

  for (int64_t i = first; s >= 0; i += stride) {
    // used in the next round: no wait for it here
    const int64_t s_after = s_next < 0 ? -1 : span_at(i + 2 * stride);
    const int64_t n0 = s * span;
    const int32_t len = static_cast<int32_t>(n0 + span < n ? span : n - n0);
    float* g_acc = acc + n0;
    const uint8_t* g_mask = mask + n0;
    const bool whole = vec && len == span;  // span % 16 == 0, aligned
    block_prefix(s_off, z_rows);
    const int32_t total = s_off[z_rows];
    int2 next_run = make_int2(0, 0);  // row threadIdx.x's run in s_next,
                                      // read at the span's end
    for (int32_t g0 = 0; g0 < total || g0 == 0; g0 += kStage) {
      const int32_t g1 = g0 + kStage < total ? g0 + kStage : total;
      // 1. this round's entries, then (first round) the span of acc and
      //    mask, all on their way at once
      constexpr int kPer = kStage / kThreads;
      int32_t pos[kPer];
      V raw[kPer];
      float scale[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {  // the loads only: none waits
        const int32_t g = g0 + u * kThreads + threadIdx.x;
        pos[u] = -1;
        raw[u] = V(0);
        scale[u] = 1.f;
        if (g < g1) {
          const int32_t z = row_of(s_off, z_rows, g);
          const int32_t j = s_lo[z] + (g - s_off[z]);
          const int64_t at = static_cast<int64_t>(z) * k + j;
          pos[u] = __ldg(idx + at);
          raw[u] = __ldg(values + at);
          if (kScales)
            scale[u] = __ldg(scales + static_cast<int64_t>(z) * k_scales +
                             (j >> log2_qb));
        }
      }
      if (g0 == 0) {
        if (whole) {
          for (int32_t c = threadIdx.x; c < len / 4; c += kThreads)
            cp_async16(s_acc + 4 * c, g_acc + 4 * c);
          for (int32_t c = threadIdx.x; c < len / 16; c += kThreads)
            cp_async16(s_mask + 16 * c, g_mask + 16 * c);
        } else {
          for (int32_t c = threadIdx.x; c < len; c += kThreads) {
            s_acc[c] = g_acc[c];
            s_mask[c] = __ldg(g_mask + c);
          }
        }
        if (s_next >= 0 && static_cast<int32_t>(threadIdx.x) < z_rows)
          next_run = run_of(sc, n_spans, threadIdx.x, s_next);
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        s_pos[u * kThreads + threadIdx.x] = pos[u];
        s_val[u * kThreads + threadIdx.x] =
            kScales ? __fmul_rn(widen(raw[u]), scale[u]) : widen(raw[u]);
      }
      if (g0 == 0 && whole) cp_async_wait_all();
      __syncthreads();
      // 2. rows in z order; a row's entries hit distinct positions
      if (g1 > g0) {
        const int32_t z_first = row_of(s_off, z_rows, g0);
        const int32_t z_last = row_of(s_off, z_rows, g1 - 1);
        for (int32_t z = z_first; z <= z_last; ++z) {
          const int32_t lo = s_off[z] > g0 ? s_off[z] : g0;
          const int32_t hi = s_off[z + 1] < g1 ? s_off[z + 1] : g1;
          if (lo >= hi) continue;  // the same for every thread
          const float wm = s_wm[z], wr = s_wr[z];
          for (int32_t g = lo + threadIdx.x; g < hi; g += kThreads) {
            const int64_t p = static_cast<int64_t>(s_pos[g - g0]) - n0;
            if (p < 0 || p >= len) continue;
            const float w = s_mask[p] ? wm : wr;
            if (!(w > 0.f)) continue;
            s_acc[p] = __fadd_rn(s_acc[p], __fmul_rn(s_val[g - g0], w));
          }
          __syncthreads();  // row z's adds land before row z + 1 reads
        }
      }
    }
    // 3. the span back to device memory, and the next span's runs in
    if (whole) {
      for (int32_t c = threadIdx.x; c < len / 4; c += kThreads)
        reinterpret_cast<float4*>(g_acc)[c] =
            reinterpret_cast<const float4*>(s_acc)[c];
    } else {
      for (int32_t c = threadIdx.x; c < len; c += kThreads)
        g_acc[c] = s_acc[c];
    }
    __syncthreads();  // shared memory is free for the next span
    if (s_next >= 0) {
      for (int32_t z = threadIdx.x; z < z_rows; z += kThreads)
        put_run(s_lo, s_off, z,
                z < kThreads ? next_run : run_of(sc, n_spans, z, s_next), k);
      __syncthreads();
    }
    s = s_next;
    s_next = s_after;
  }
}

template <typename V, bool kScales>
cudaError_t launch_apply(void* acc, const void* values, const void* scales,
                         const void* idx, const void* mask, const void* w_m,
                         const void* w_rest, const Scratch& sc, int32_t z,
                         int32_t k, int64_t n, int log2_qb, int64_t span,
                         int64_t n_spans, int vec, cudaStream_t stream) {
  const size_t smem = apply_smem(span, z);
  auto kernel = scatter_apply<V, kScales>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  int64_t blocks = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > n_spans) blocks = n_spans;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<float*>(acc), static_cast<const V*>(values),
      static_cast<const float*>(scales), static_cast<const int32_t*>(idx),
      static_cast<const uint8_t*>(mask), static_cast<const float*>(w_m),
      static_cast<const float*>(w_rest), sc, z, k, n, log2_qb, span,
      n_spans, vec);
  return cudaGetLastError();
}

}  // namespace

// span: the acc positions one block owns at a time, a power of two in
// [kMinSpan, kMaxSpan] that the wrapper picks from (n, z, k)
// (ops.scatter_span); scratch: int32 of (2 z + 2) n_spans + 1 elements
// with n_spans = ceil(n / span), allocated by the wrapper (uninitialised:
// this memsets it).  value_kind: 0 = f32, 1 = bf16, 2 = int8.
// scales may be null.
extern "C" int masked_scatter_acc_launch(void* acc, const void* values,
                                         const void* scales, const void* idx,
                                         const void* mask, const void* w_m,
                                         const void* w_rest, void* scratch,
                                         int32_t z, int32_t k, int64_t n,
                                         int64_t span, int log2_qb,
                                         int value_kind, void* stream) {
  if (z <= 0 || k <= 0 || n <= 0) return 0;
  if (z > kMaxRows || value_kind < 0 || value_kind > 2 || span < kMinSpan ||
      span > kMaxSpan || (span & (span - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_spans = (n + span - 1) / span;
  const Scratch sc = scratch_at(static_cast<int32_t*>(scratch), z, n_spans);
  const size_t words = static_cast<size_t>((2 * int64_t{z} + 2) * n_spans + 1);
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(int32_t) * words, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int log2_span = 0;
  while ((int64_t{1} << log2_span) < span) ++log2_span;
  const dim3 grid(static_cast<unsigned>((k + kBoundsPer * kThreads - 1) /
                                        (kBoundsPer * kThreads)),
                  static_cast<unsigned>(z));
  const int idx_vec = !(reinterpret_cast<uintptr_t>(idx) & 15u) && !(k & 3);
  scatter_bounds<<<grid, kThreads, 0, s>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(w_m),
      static_cast<const float*>(w_rest), sc, k, n, log2_span,
      static_cast<int32_t>(n_spans), idx_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = !(reinterpret_cast<uintptr_t>(acc) & 15u) &&
                  !(reinterpret_cast<uintptr_t>(mask) & 15u);
  const bool sc_ = scales != nullptr;
#define APPLY(V, S)                                                          \
  launch_apply<V, S>(acc, values, scales, idx, mask, w_m, w_rest, sc, z, k, \
                     n, log2_qb, span, n_spans, vec, s)
  switch (value_kind) {
    case 0: err = sc_ ? APPLY(float, true) : APPLY(float, false); break;
    case 1: err = sc_ ? APPLY(uint16_t, true) : APPLY(uint16_t, false); break;
    default: err = sc_ ? APPLY(int8_t, true) : APPLY(int8_t, false); break;
  }
#undef APPLY
  return static_cast<int>(err);
}
