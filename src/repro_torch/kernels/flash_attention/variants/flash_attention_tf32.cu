// K5's f32 forward in split TF32 on Hopper's tensor cores (wgmma): a
// measured variant, not built into the kernel library (kernels/build.py
// takes only */csrc/*.cu).  launch/tune_flash.py builds it alone, with the
// same C entry as csrc/flash_attention.cu, and holds it beside that kernel
// against the plain version.  It is fast (5.89 ms at recurrentgemma-2b's
// f32 shape against 9.79 ms for the earlier CUDA-core kernel, on an H100
// 80GB HBM3 at 700 W) but leaves max|diff| 1.84e-5 there against the f32
// tolerance of 1e-5, and 1.7e-5 even with q, k and v exact in TF32 (every
// product exact, so the split is not at fault).  A CUDA-core kernel that
// summed Dh in two halves left 1.99e-5 there too: at these logits any
// summation order but the plain version's sequential one moves the output
// by about 1e-5, and the tensor cores sum 8 products at a time in their
// own order.  So the f32 route stays on the CUDA cores.
//
// It computes what csrc/flash_attention.cu computes:
//
//   out[b, i, h] = sum_j softmax_j(cap(q[b, i, h] . k[b, j, h / G] * Dh^-0.5))
//                  * v[b, j, h / G]
//
// over the keys j with j <= i and, when window > 0, i - j < window.
// q (B, S, H, Dh), k and v (B, S, Kh, Dh), f32, contiguous, 16-byte
// aligned; G = H / Kh, so query head h reads kv head h / G.  cap(x) =
// tanh(x / softcap) * softcap when softcap > 0.  Dh is 32, 64, 128 or 256.
//
// Accuracy: split TF32.  Each f32 operand x is split into hi = rna_tf32(x)
// and lo = rna_tf32(x - hi); each product is taken as hi.hi + hi.lo +
// lo.hi, three TF32 products accumulated in f32 by the tensor cores, which
// leaves x.y to about 2^-22 relative (lo.lo is dropped).  That applies to
// S = Q K^T and to O = P V, with the probabilities P split the same way.
// The scale, the softcap (tanhf), the online softmax (m, l, the rescale
// alpha, expf) and out = acc / max(l, 1e-30) stay in f32 as in the earlier
// CUDA-core kernel.  No library TF32: the split is this file's arithmetic.
//
// Bound: operations.  Each kept (query, key) pair costs 4 * Dh flops of f32
// products (score and its share of P V); in split TF32 each is three TF32
// products, so the route's peak is 495 / 3 = 165 TFLOP/s of f32 products
// (dense TF32 on an H100 SXM), against 67 TFLOP/s on the CUDA cores.
//
// Design.  One block of 256 threads, two warpgroups, per (batch, kv head,
// group of query heads, block of queries): its 64 rows are (query, head)
// pairs of one kv head in query-major order, g_blk = min(G, 64) heads times
// bq = 64 / g_blk queries, so each K/V tile serves the whole head group.
//   Warpgroup 0 (consumer) computes the 64 rows:
//     S = Q K^T  wgmma m64nBKk8, A (Q) from registers, B (K) from shared
//                memory; Q sits in shared memory once, f32, in each
//                thread's fragment order, and is split into hi and lo in
//                registers a few k-steps at a time (wgmma reads register
//                operands asynchronously, so each batch stays live until
//                the wait that retires it);
//     O += P V   wgmma m64n32k8 per 32 output columns, A (P) from
//                registers (the S accumulator's fragment, its keys taken
//                in the order (0, 2, 4, 6, 1, 3, 5, 7) within each 8 so
//                that it is already the A layout), B (V transposed) from
//                shared memory.
//   The tensor cores sum only short chains: each batch of Q's k-steps'
//   hi.hi products for S (the small hi.lo and lo.hi products in a chain of
//   their own), and each tile's keys for a 32-column block of O, from
//   zero; the CUDA cores add those partial sums into f32 registers
//   rounded to nearest.  Left to the tensor cores, a chain over thousands
//   of keys lost about an ulp of the running sum at each add (6.4e-5 at
//   recurrentgemma's shape, against the 1e-5 tolerance).
//   Warpgroup 1 (producer) loads the next K and V tiles from global memory
//   into registers, splits them into hi and lo, and stores them in wgmma's
//   128-byte swizzled K-major layout: K as (key, Dh), V transposed as
//   (Dh, key) with the key order above (TF32 wgmma has no transpose, and
//   TMA cannot transpose 4-byte elements).  One stage of each: K is
//   refilled while the consumer works on P V, V while it works on the
//   next S, through four mbarriers (K full / empty, V full / empty).
// Keys come in tiles of BK = 64 (32 at Dh 256).  Shared memory at Dh 256:
// Q 64 KiB + 4 x 32 KiB (K hi, K lo, V hi, V lo) + 1 KiB for the swizzle's
// alignment = 193 KiB, one block an SM.  At Dh 32 a row of 32 floats is
// one 128-byte swizzle line, so no padding.
// The block walks only keys some row can see, from max(0, q0 - window + 1)
// to its last query; the per-element causal/window test runs only on tiles
// that cross the diagonal or the window's edge.  Masked scores are -inf; a
// row with no key yet keeps m = -inf and takes p = 0 and alpha = 0, so a
// wholly masked tile adds nothing whatever order the tiles come in.  Blocks
// are numbered so that the q-blocks with the most keys start first.
//
// Plain C interface, loaded with ctypes.  The entry point returns the
// cudaError_t of its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // consumer warpgroup + producer warpgroup
constexpr int kRows = 64;       // (query, head) rows per block

template <int DH>
struct Cfg {
  static constexpr int BK = DH == 256 ? 32 : 64;  // keys per tile
  static constexpr int PN = 32;                   // P V wgmma width
  static constexpr int NB = DH / PN;              // P V column blocks
  static constexpr int KSTEPS = DH / 8;           // S k-steps (k8)
  static constexpr int KC = 2;                    // Q k-steps a batch
  static constexpr int TILE = BK * DH * 4;        // one K or V part
  static constexpr int Q_BYTES = kRows * DH * 4;
  // K hi, K lo, V hi, V lo, Q, 4 mbarriers; + 1 KiB to align the base
  static constexpr int SMEM = 4 * TILE + Q_BYTES + 64 + 1024;
  static constexpr int KV4 = BK * DH / 4 / 128;   // K float4s a producer
  static constexpr int UNITS = BK / 8 * DH / 4;   // V units of 8 x 4
  static constexpr int UPT = (UNITS + 127) / 128;
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}
// x = hi + lo to about 2^-22 relative, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// element e (a constant once unrolled) of a float4
__device__ __forceinline__ float lane4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Byte offset of 16-byte chunk `ch` (of the line's 8) of row r in a
// 128-byte swizzled tile of `rows` rows: column block cb, chunk XOR row.
__device__ __forceinline__ uint32_t swz(int cb, int r, int ch, int rows) {
  return static_cast<uint32_t>(cb * rows * 128 + r * 128 +
                               ((ch ^ (r & 7)) << 4));
}

__device__ __forceinline__ void st_shared4(uint32_t addr, uint32_t a,
                                           uint32_t b, uint32_t c,
                                           uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}
__device__ __forceinline__ float4 ld_shared4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// the producer's generic-proxy stores, before wgmma reads them (async
// proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          bar)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (K-major: the leading
// offset is ignored; the stride offset is the 1024 bytes between 8-row
// atoms)
__device__ __forceinline__ uint64_t sdesc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads of an accumulator above the wait,
// and an asynchronously read A operand's registers from being reused
// before it
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define D16(d)                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define D32(d)                                                              \
  D16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),  \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define R16                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define R32                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d = A B (+ d when acc), A (TF32, the m64k8 fragment) from registers, B
// (K-major TF32) from shared memory; N = 32 or 64 columns
__device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4],
                                    uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " R16
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : D16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
__device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                    uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

#undef D16
#undef D32
#undef R16
#undef R32

// d (+)= (ah + al) (bh + bl) less al bl: three TF32 products; d is
// overwritten when acc is 0
template <int N>
__device__ __forceinline__ void mma3(float (&d)[N], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint64_t bh,
                                     uint64_t bl, int acc) {
  mma(d, ah, bh, acc);
  mma(d, ah, bl, 1);
  mma(d, al, bh, 1);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Warpgroup 1: K and V tiles from global memory, split, into shared memory.
template <int DH>
__device__ void producer(uint32_t kh, uint32_t kl, uint32_t vh, uint32_t vl,
                         uint32_t bars, const float* kb, const float* vb,
                         int64_t ktok, int k_begin, int n_tiles, int s_len,
                         int tid) {
  using C = Cfg<DH>;
  constexpr int BK = C::BK, KG = BK / 8, CQ = DH / 4;
  float4 kr[C::KV4], vr[C::UPT][8];

  auto load_k = [&](int k0) {
#pragma unroll
    for (int u = 0; u < C::KV4; ++u) {
      const int idx = tid + 128 * u, r = idx / CQ, c4 = idx % CQ;
      kr[u] = k0 + r < s_len
                  ? *reinterpret_cast<const float4*>(kb + (k0 + r) * ktok +
                                                     4 * c4)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  // a V unit: keys 8 kg .. 8 kg + 7 of Dh columns 4 cq .. 4 cq + 3
  auto load_v = [&](int k0) {
#pragma unroll
    for (int w = 0; w < C::UPT; ++w) {
      const int idx = tid + 128 * w, kg = idx % KG, cq = idx / KG;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int key = k0 + 8 * kg + r;
        vr[w][r] = idx < C::UNITS && key < s_len
                       ? *reinterpret_cast<const float4*>(vb + key * ktok +
                                                          4 * cq)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };
  auto store_k = [&]() {
#pragma unroll
    for (int u = 0; u < C::KV4; ++u) {
      const int idx = tid + 128 * u, r = idx / CQ, c4 = idx % CQ;
      const uint32_t off = swz(c4 >> 3, r, c4 & 7, BK);
      uint32_t h[4], l[4];
      split(kr[u].x, h[0], l[0]);
      split(kr[u].y, h[1], l[1]);
      split(kr[u].z, h[2], l[2]);
      split(kr[u].w, h[3], l[3]);
      st_shared4(kh + off, h[0], h[1], h[2], h[3]);
      st_shared4(kl + off, l[0], l[1], l[2], l[3]);
    }
  };
  // V transposed: row n = Dh column, K position 8 kg + c holds key 8 kg +
  // (c < 4 ? 2c : 2c - 7).  Odd cq write their two chunks in the other
  // order, so a warp's stores meet all eight 16-byte bank groups.
  auto store_v = [&]() {
#pragma unroll
    for (int w = 0; w < C::UPT; ++w) {
      const int idx = tid + 128 * w, kg = idx % KG, cq = idx / KG;
      if (idx >= C::UNITS) continue;
      const int flip = cq & 1;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 4 * cq + e;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int half = hf ^ flip;
          uint32_t h[4], l[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            split(half ? lane4(vr[w][2 * j + 1], e) : lane4(vr[w][2 * j], e),
                  h[j], l[j]);
          const uint32_t off =
              swz(kg >> 2, n, 2 * (kg & 3) + half, DH);
          st_shared4(vh + off, h[0], h[1], h[2], h[3]);
          st_shared4(vl + off, l[0], l[1], l[2], l[3]);
        }
      }
    }
  };

  const uint32_t k_full = bars, k_empty = bars + 8, v_full = bars + 16,
                 v_empty = bars + 24;
  load_k(k_begin);
  load_v(k_begin);
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_begin + j * BK;
    if (j > 0) mbar_wait(k_empty, (j - 1) & 1);
    store_k();
    fence_proxy_async();
    mbar_arrive(k_full);
    if (j + 1 < n_tiles) load_k(k0 + BK);
    if (j > 0) mbar_wait(v_empty, (j - 1) & 1);
    store_v();
    fence_proxy_async();
    mbar_arrive(v_full);
    if (j + 1 < n_tiles) load_v(k0 + BK);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32(float* __restrict__ out, const float* __restrict__ q,
               const float* __restrict__ k, const float* __restrict__ v,
               int s_len, int n_heads, int n_kv, int n_bk, int g_blk, int bq,
               int n_qblk, int n_grp, int window, float softcap,
               float scale) {
  using C = Cfg<DH>;
  constexpr int BK = C::BK, PN = C::PN, NB = C::NB, KC = C::KC;
  constexpr int NCH = C::KSTEPS / KC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) &
      ~1023u;
  const uint32_t kh = base, kl = kh + C::TILE, vh = kl + C::TILE,
                 vl = vh + C::TILE, qf = vl + C::TILE,
                 bars = qf + C::Q_BYTES;

  // block -> (q-block, head group, batch x kv head); most keys first
  const int bid = blockIdx.x;
  const int qblk = n_qblk - 1 - bid / (n_grp * n_bk);
  const int grp = (bid / n_bk) % n_grp;
  const int bk = bid % n_bk;
  const int g = n_heads / n_kv;
  const int b = bk / n_kv, kvh = bk % n_kv;
  const int g0 = grp * g_blk;
  const int q0 = qblk * bq;
  const int tid = threadIdx.x;
  const int64_t tok = static_cast<int64_t>(n_heads) * DH;   // q/out stride
  const int64_t ktok = static_cast<int64_t>(n_kv) * DH;     // k/v stride

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) mbar_init(bars + 8 * i, 128);
  }
  // Q rows (dead rows are 0), f32, scattered into each consumer thread's
  // A-fragment order: k-step kk of thread t at (kk * 128 + t) * 16 bytes,
  // its four values (row g, col c), (g + 8, c), (g, c + 4), (g + 8, c + 4)
  // with g = lane / 4 of its warp's 16 rows and c = 8 kk + lane % 4
  for (int idx = tid; idx < kRows * DH / 4; idx += kThreads) {
    const int r = idx / (DH / 4), c = (idx % (DH / 4)) * 4;
    const int qi = r / g_blk, gi = r % g_blk, qp = q0 + qi;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qi < bq && g0 + gi < g && qp < s_len)
      val = *reinterpret_cast<const float4*>(
          q + (static_cast<int64_t>(b) * s_len + qp) * tok +
          static_cast<int64_t>(kvh * g + g0 + gi) * DH + c);
    const int ct = 32 * (r >> 4) + 4 * (r & 7);   // + lane % 4 below
    const int slot = ((r >> 3) & 1) + 2 * ((c >> 2) & 1);
    const uint32_t at = qf + (c >> 3) * 128 * 16 + slot * 4;
    const float vals[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(at + (ct + e) * 16),
                   "f"(vals[e])
                   : "memory");
  }
  __syncthreads();

  const int q_last = min(q0 + bq, s_len) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int n_tiles = (q_last - k_begin) / BK + 1;
  if (tid >= 128) {
    const float* kb = k + static_cast<int64_t>(b) * s_len * ktok +
                      static_cast<int64_t>(kvh) * DH;
    const float* vb = v + static_cast<int64_t>(b) * s_len * ktok +
                      static_cast<int64_t>(kvh) * DH;
    producer<DH>(kh, kl, vh, vl, bars, kb, vb, ktok, k_begin, n_tiles, s_len,
                 tid - 128);
    return;
  }

  // consumer: this thread's two rows (accumulator rows lane / 4 and
  // lane / 4 + 8 of its warp's 16)
  const int warp = tid >> 5, lane = tid & 31;
  int qpos[2], head[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + (lane >> 2) + 8 * i;
    const int qi = r / g_blk, gi = r % g_blk;
    qpos[i] = q0 + qi;
    head[i] = kvh * g + g0 + gi;
    live[i] = qi < bq && g0 + gi < g && qpos[i] < s_len;
  }
  const int wq_hi = q_last;     // the block's live queries: q0 .. q_last
  const bool capped = softcap > 0.f;
  const uint32_t k_full = bars, k_empty = bars + 8, v_full = bars + 16,
                 v_empty = bars + 24;

  float o[NB][PN / 2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < PN / 2; ++e) o[nb][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // Q k-steps c * KC .. c * KC + KC - 1, split into hi and lo
  auto load_q = [&](int c, uint32_t (&ah)[KC][4], uint32_t (&al)[KC][4]) {
#pragma unroll
    for (int u = 0; u < KC; ++u) {
      const float4 x = ld_shared4(qf + ((c * KC + u) * 128 + tid) * 16);
      split(x.x, ah[u][0], al[u][0]);
      split(x.y, ah[u][1], al[u][1]);
      split(x.z, ah[u][2], al[u][2]);
      split(x.w, ah[u][3], al[u][3]);
    }
  };

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_begin + j * BK;

    // S = Q K^T, Q's k-steps in batches of KC.  The tensor cores sum each
    // batch's hi.hi products alone (sp, from zero), and the CUDA cores add
    // the batches in f32 rounded to nearest (s); the small hi.lo and lo.hi
    // products go to an accumulator of their own (sl) over the whole
    // tile, added last.  The tensor cores' own f32 sums lose up to about
    // an ulp of the running sum at each add: over a long chain, or with
    // the small products in the big sum, that exceeds the f32 tolerance.
    // Each batch is two commit groups (hi.hi, then the small products), so
    // the small products of batch c run while batch c's sp is added and
    // batch c + 1's Q is split; A is double-buffered for that.
    float s[BK / 2], sl[BK / 2], sp[BK / 2];
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) s[e] = 0.f;
    uint32_t ah[2][KC][4], al[2][KC][4];
    load_q(0, ah[0], al[0]);
    mbar_wait(k_full, j & 1);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int cur = c & 1;
      wg_fence();
#pragma unroll
      for (int u = 0; u < KC; ++u) {
        const int kk = c * KC + u;
        const uint32_t off = (kk >> 2) * (BK * 128) + (kk & 3) * 32;
        mma(sp, ah[cur][u], sdesc(kh + off), u > 0);
      }
      wg_commit();
#pragma unroll
      for (int u = 0; u < KC; ++u) {
        const int kk = c * KC + u;
        const uint32_t off = (kk >> 2) * (BK * 128) + (kk & 3) * 32;
        mma(sl, ah[cur][u], sdesc(kl + off), c > 0 || u > 0);
        mma(sl, al[cur][u], sdesc(kh + off), 1);
      }
      wg_commit();
      wg_wait<1>();   // batch c's hi.hi, and every group before it, is done
      reg_fence(sp);
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) s[e] += sp[e];
      if (c > 0) {    // batch c - 1's small products are done: free its A
#pragma unroll
        for (int u = 0; u < KC; ++u) {
          reg_fence(ah[cur ^ 1][u]);
          reg_fence(al[cur ^ 1][u]);
        }
      }
      if (c + 1 < NCH) load_q(c + 1, ah[cur ^ 1], al[cur ^ 1]);
    }
    wg_wait<0>();
    reg_fence(sl);
#pragma unroll
    for (int u = 0; u < KC; ++u) {
      reg_fence(ah[(NCH - 1) & 1][u]);
      reg_fence(al[(NCH - 1) & 1][u]);
    }
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) s[e] += sl[e];
    mbar_arrive(k_empty);

    // s[4c + 2i + e] is row i, key k0 + 8c + 2 (lane % 4) + e
    const bool need_mask =
        k0 + BK - 1 > q0 || (window > 0 && k0 < wq_hi - window + 1);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int i = (e >> 1) & 1;
      float x = s[e] * scale;
      if (capped) x = tanhf(x / softcap) * softcap;
      if (need_mask) {
        const int kp = k0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
        const bool keep = live[i] && kp <= qpos[i] &&
                          (window <= 0 || qpos[i] - kp < window);
        x = keep ? x : -INFINITY;
      }
      s[e] = x;
      mx[i] = fmaxf(mx[i], x);
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = expf(m[i] - m_use[i]);   // 0 while m[i] is -inf
      m[i] = m_new;
      l[i] *= alpha[i];
    }
    // P split: the A fragment of k-step kk is rows (g, g + 8) x keys
    // (2t, 2t + 1) of that step, which the V tile's key order matches
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int e = 4 * kk + (a >> 1) + 2 * (a & 1);   // 0, 2, 1, 3
        const int i = a & 1;
        const float p = expf(s[e] - m_use[i]);           // 0 when masked
        l[i] += p;
        split(p, ph[kk][a], pl[kk][a]);
      }
    }

    // O = alpha O + P V, a column block of PN at a time: the tensor cores
    // sum the tile's keys for a block alone (op, from zero), the CUDA
    // cores fold it into O in f32 (fmaf), as for S above
    float op[2][PN / 2];
    mbar_wait(v_full, j & 1);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        const uint32_t off =
            (kk >> 2) * (DH * 128) + nb * (PN * 128) + (kk & 3) * 32;
        mma3(op[nb & 1], ph[kk], pl[kk], sdesc(vh + off), sdesc(vl + off),
             kk > 0);
      }
      wg_commit();
      if (nb > 0) {
        wg_wait<1>();         // block nb - 1 is done
        const int pb = (nb - 1) & 1;
        reg_fence(op[pb]);
#pragma unroll
        for (int e = 0; e < PN / 2; ++e)
          o[nb - 1][e] = fmaf(o[nb - 1][e], alpha[(e >> 1) & 1], op[pb][e]);
      }
    }
    wg_wait<0>();
    reg_fence(op[(NB - 1) & 1]);
#pragma unroll
    for (int e = 0; e < PN / 2; ++e)
      o[NB - 1][e] = fmaf(o[NB - 1][e], alpha[(e >> 1) & 1],
                          op[(NB - 1) & 1][e]);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      reg_fence(ph[kk]);
      reg_fence(pl[kk]);
    }
    mbar_arrive(v_empty);
  }

  // out = O / max(l, 1e-30)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float den = fmaxf(quad_sum(l[i]), 1e-30f);
    if (!live[i]) continue;
    float* orow = out + (static_cast<int64_t>(b) * s_len + qpos[i]) * tok +
                  static_cast<int64_t>(head[i]) * DH;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int c = 0; c < PN / 8; ++c) {
        const int col = nb * PN + 8 * c + 2 * (lane & 3);
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(o[nb][4 * c + 2 * i] / den,
                        o[nb][4 * c + 2 * i + 1] / den);
      }
  }
}

template <int DH>
cudaError_t launch(void* out, const void* q, const void* k, const void* v,
                   int b, int s, int h, int kh, int window, float softcap,
                   float scale, cudaStream_t stream) {
  constexpr int smem = Cfg<DH>::SMEM;
  const int g = h / kh;
  const int g_blk = g < kRows ? g : kRows;
  const int bq = kRows / g_blk;
  const int n_qblk = (s + bq - 1) / bq, n_grp = (g + g_blk - 1) / g_blk;
  const long long blocks = static_cast<long long>(n_qblk) * n_grp * b * kh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_tf32<DH><<<static_cast<unsigned>(blocks), kThreads, smem,
                       stream>>>(
      static_cast<float*>(out), static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v), s, h, kh,
      b * kh, g_blk, bq, n_qblk, n_grp, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_fwd(void* out, const void* q, const void* k,
                                   const void* v, int b, int s, int h,
                                   int kh, int dh, int window, float softcap,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dh) {
    case 32: err = launch<32>(out, q, k, v, b, s, h, kh, window, softcap,
                              scale, st); break;
    case 64: err = launch<64>(out, q, k, v, b, s, h, kh, window, softcap,
                              scale, st); break;
    case 128: err = launch<128>(out, q, k, v, b, s, h, kh, window, softcap,
                                scale, st); break;
    case 256: err = launch<256>(out, q, k, v, b, s, h, kh, window, softcap,
                                scale, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// the smem bytes the launch above asks for at head dim dh (0: none), so
// the wrapper's plan can be held to the kernel's
extern "C" int flash_attention_f32_smem(int dh) {
  switch (dh) {
    case 32: return Cfg<32>::SMEM;
    case 64: return Cfg<64>::SMEM;
    case 128: return Cfg<128>::SMEM;
    case 256: return Cfg<256>::SMEM;
    default: return 0;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
