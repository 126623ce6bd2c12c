// Causal, optionally sliding-window, GQA flash attention, forward only, for
// bf16 inputs on Hopper's tensor cores (wgmma).
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (body _flash_kernel) for bf16 inputs, and computes what it computes:
//
//   out[b, i, h] = sum_j softmax_j(cap(q[b, i, h] . k[b, j, h / G] * Dh^-0.5))
//                  * v[b, j, h / G]
//
// over the keys j with j <= i and, when window > 0, i - j < window.
// q (B, S, H, Dh), k and v (B, S, Kh, Dh), bf16, contiguous, 16-byte
// aligned; G = H / Kh; cap(x) = tanh(x / softcap) * softcap when softcap > 0.
// The _rows entry takes a query offset: q (B, Sq, H, Dh) holds the rows at
// positions q_off .. q_off + Sq - 1 of a sequence whose keys k, v are (B,
// Sk, Kh, Dh), q_off + Sq <= Sk (a rank's rows of a sequence split over
// ranks, against the key prefix it can see); i above is the position.  The
// masks, the first key block and the heaviest-first order use positions,
// the rows of q and out their local index.  q_off = 0 with Sq = Sk is the
// plain entry, the same arithmetic.
// Scores, the online softmax (m, l) and the output accumulator are f32; the
// probabilities enter the PV product rounded to bf16, as the model's
// _attend rounds them (probs.astype(v.dtype)), and l sums those same
// rounded values; out is acc / max(l, 1e-30) rounded once to bf16.  Dh is
// 32, 64, 112, 128 or 256: shared memory holds Dh rounded up to whole
// 64-column blocks (32 padded to 64, 112 to 128), the padding columns of Q,
// K and V loaded as 0, so S = Q K^T sums exact zeros past Dh and P V's
// padding columns are computed and not stored.  f32 inputs go to the
// CUDA-core kernel (flash_attention.cu), which keeps f32 products.
//
// Bound: operations.  Each kept (query, key) pair costs 4 * Dh flops (its
// score and its share of P.V), at 989 TFLOP/s dense bf16; the bytes (q, k,
// v and out once) are two orders of magnitude fewer at the path's lengths.
//
// Design.  One block of 256 threads, two consumer warpgroups, takes 128
// rows: (query, head) pairs of one kv head in query-major order, g_blk =
// min(G, 128) heads times bq = 128 / g_blk queries (recurrentgemma's MQA,
// G = 10: 12 queries, 120 live rows), so each K/V tile serves the whole
// group.  Warpgroup w computes rows 64w..64w+63:
//   S = Q K^T   wgmma m64n64k16, Q and K from shared memory (K-major);
//   O += P V    wgmma m64n64k16 per 64 output columns, P from registers
//               (the S accumulator's fragment is the A operand's layout),
//               V from shared memory through the transposed-B form.
// Q, K and V stay bf16 in shared memory in wgmma's 128-byte swizzled layout
// (column blocks of 64 elements, 8-row atoms of 1024 bytes).  K/V tiles of
// 64 keys sit in a ring of two stages filled by cp.async: the copy of tile
// j+1 starts before the math on tile j and overlaps it.  At Dh 256 that
// is Q 64 KiB + 2 x (K 32 KiB + V 32 KiB) = 192 KiB, one block per SM.  The
// block walks only keys some row can see, from max(0, q0 - window + 1) to
// its last query; the per-element causal/window test runs only on tiles
// that cross the diagonal or the window's edge (per warpgroup), interior
// tiles skip it.  Masked scores are -inf; a row with no key yet keeps m =
// -inf and takes p = 0 and alpha = 0, so no tile order lets garbage in.
// Within a tile the warpgroups take the tensor cores in turn (named
// barriers): warpgroup 1 starts each product after warpgroup 0's has
// finished, so one's softmax overlaps the other's product.
// The softcap is applied in f32 on the accumulator fragment with
// tanh.approx.  Blocks are numbered so that the q-blocks with the most keys
// (the last ones of a global causal launch) start first.
//
// Plain C interface, loaded with ctypes; the launch plan (g_blk, bq, shared
// memory) comes from the wrapper (ops.plan_wgmma).  The entry point returns
// the cudaError_t of its launch; the wrapper raises on anything but success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // two consumer warpgroups
constexpr int kRows = 128;      // (query, head) rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kStages = 2;      // K/V ring
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Tile {
  // head dim in shared memory: whole 64-column (128-byte) blocks
  static constexpr int DP = DH <= 64 ? 64 : (DH + 63) / 64 * 64;
  static constexpr int NB = DP / 64;              // 128-byte column blocks
  static constexpr int CPR = DP / 8;              // 16-byte chunks per row
  static constexpr int Q_BYTES = kRows * DP * 2;
  static constexpr int KV_BYTES = kBK * DP * 2;   // one K or one V tile
  // + 1 KiB to align the base to the swizzle's 1024-byte atom
  static constexpr int SMEM = Q_BYTES + kStages * 2 * KV_BYTES + 1024;
};

// Byte offset of 16-byte chunk `ch` (of DP / 8) of row r in a swizzled tile
// of `rows` rows: column block ch / 8, row pitch 128 bytes, chunk XOR row.
__device__ __forceinline__ uint32_t swz(int r, int ch, int rows) {
  return static_cast<uint32_t>((ch >> 3) * rows * 128 + r * 128 +
                               (((ch & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// cp.async writes through the generic proxy, wgmma reads through the async
// proxy: each writer fences before the barrier that publishes the tile
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start, leading and
// stride byte offsets in 16-byte units.  K-major operands ignore the
// leading offset; the stride offset is the 1024 bytes between 8-row atoms.
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo,
                                          uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads of an accumulator above the wait
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define D32(d)                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define R32                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (+)= A B, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, A (bf16 pairs) from registers, B from shared memory N-major
// (the transposed-B form).
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef D32
#undef R32

// named barriers 1 and 2 (0 is __syncthreads) between the two warpgroups
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float ex2(float x) {   // ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Start the cp.async copies of keys k0..k0+63 of K and V into one stage
// (rows at or beyond s_len, and the padding columns past Dh, read as 0; a
// row of Dh 112 is 14 16-byte chunks, so every copy stays aligned).
template <int DH>
__device__ __forceinline__ void load_kv(uint32_t ks, uint32_t vs,
                                        const uint16_t* kb,
                                        const uint16_t* vb, int64_t ktok,
                                        int k0, int s_len, int tid) {
  using T = Tile<DH>;
  constexpr int kRowsPerPass = kThreads / T::CPR;
  const int ch = tid % T::CPR, r0 = tid / T::CPR;
  const bool col_ok = ch * 8 < DH;
#pragma unroll
  for (int u = 0; u < kBK / kRowsPerPass; ++u) {
    const int r = r0 + u * kRowsPerPass;
    const bool ok = col_ok && k0 + r < s_len;
    const int64_t off = ok ? (k0 + r) * ktok + ch * 8 : 0;
    const uint32_t dst = swz(r, ch, kBK);
    cp_async16(ks + dst, kb + off, ok);
    cp_async16(vs + dst, vb + off, ok);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(uint16_t* __restrict__ out, const uint16_t* __restrict__ q,
                const uint16_t* __restrict__ k,
                const uint16_t* __restrict__ v, int s_len, int s_kv,
                int q_off, int n_heads, int n_kv, int n_bk, int g_blk, int bq,
                int n_qblk, int n_grp, int window, float softcap,
                float scale) {
  using T = Tile<DH>;
  constexpr int NB = T::NB, KSTEPS = T::DP / 16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) &
      ~1023u;
  const uint32_t qs = base;                          // kRows x DP
  const uint32_t kv0 = base + T::Q_BYTES;            // stage st: K, then V

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
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int64_t tok = static_cast<int64_t>(n_heads) * DH;   // q/out stride
  const int64_t ktok = static_cast<int64_t>(n_kv) * DH;     // k/v stride
  const uint16_t* kb = k + static_cast<int64_t>(b) * s_kv * ktok +
                       static_cast<int64_t>(kvh) * DH;
  const uint16_t* vb = v + static_cast<int64_t>(b) * s_kv * ktok +
                       static_cast<int64_t>(kvh) * DH;

  // Q rows of the block (dead rows and padding columns are 0)
  {
    constexpr int kRowsPerPass = kThreads / T::CPR;
    const int ch = tid % T::CPR, r0 = tid / T::CPR;
    for (int r = r0; r < kRows; r += kRowsPerPass) {
      const int qi = r / g_blk, gi = r % g_blk, qp = q0 + qi;
      const bool ok = ch * 8 < DH && qi < bq && g0 + gi < g && qp < s_len;
      const uint16_t* src =
          ok ? q + (static_cast<int64_t>(b) * s_len + qp) * tok +
                   static_cast<int64_t>(kvh * g + g0 + gi) * DH + ch * 8
             : q;
      cp_async16(qs + swz(r, ch, kRows), src, ok);
    }
  }

  // positions: the block's last query and its first visible key
  const int q_last = q_off + min(q0 + bq, s_len) - 1;
  const int k_begin = window > 0 ? max(0, q_off + q0 - window + 1) : 0;
  const int n_tiles = (q_last - k_begin) / kBK + 1;
  load_kv<DH>(kv0, kv0 + T::KV_BYTES, kb, vb, ktok, k_begin, s_kv, tid);
  cp_async_commit();

  // this thread's two rows (accumulator rows lane/4 and lane/4 + 8 of its
  // warp's 16): query row of q, its position, and liveness
  int qrow[2], qpos[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wg * 64 + warp * 16 + (lane >> 2) + 8 * i;
    const int qi = r / g_blk, gi = r % g_blk;
    qrow[i] = q0 + qi;
    qpos[i] = q_off + qrow[i];
    live[i] = qi < bq && g0 + gi < g && qrow[i] < s_len;
  }
  // the warpgroup's live queries' positions, for the per-tile mask decision
  const int wq_lo = q_off + q0 + (wg * 64) / g_blk;
  const int wq_hi =
      q_off + min(q0 + min((wg * 64 + 63) / g_blk, bq - 1), s_len - 1);
  const bool wg_dead = wq_lo > wq_hi;

  const bool capped = softcap > 0.f;
  const float s_mul = capped ? scale / softcap : scale * kLog2e;
  const float c_mul = softcap * kLog2e;
  const uint32_t q_wg = qs + wg * 64 * 128;

  float o[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[nb][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    const int k0 = k_begin + j * kBK;
    const uint32_t ks = kv0 + st * 2 * T::KV_BYTES, vs = ks + T::KV_BYTES;
    cp_async_wait_all();        // tile j (and, at j = 0, Q) has landed
    fence_proxy_async();
    __syncthreads();            // ... for every thread; tile j-1 is done
    if (j + 1 < n_tiles) {
      const uint32_t kn = kv0 + (st ^ 1) * 2 * T::KV_BYTES;
      load_kv<DH>(kn, kn + T::KV_BYTES, kb, vb, ktok, k0 + kBK, s_kv, tid);
    }
    cp_async_commit();

    // S = Q K^T for this warpgroup's 64 rows and the tile's 64 keys
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = 0.f;
    if (wg == 1) named_sync(1);     // after warpgroup 0's S product
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint32_t off = (kk & 3) * 32;   // 16 columns = 32 bytes
      wgmma_ss(s,
               sdesc(q_wg + (kk >> 2) * (kRows * 128) + off, 16, 1024),
               sdesc(ks + (kk >> 2) * (kBK * 128) + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    reg_fence(s);
    if (wg == 0) named_arrive(1);

    // scores in log2 units: s[4c + 2i + e] is row i, key k0 + 8c +
    // 2 (lane % 4) + e
    const bool need_mask = wg_dead || k0 + kBK - 1 > wq_lo ||
                           (window > 0 && k0 < wq_hi - window + 1);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      float x = capped ? c_mul * tanh_approx(s[e] * s_mul) : s[e] * s_mul;
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
      alpha[i] = ex2(m[i] - m_use[i]);           // 0 while m[i] is -inf
      m[i] = m_new;
      l[i] *= alpha[i];
    }
    // P in bf16: the A fragment of k-step kk is s[8kk .. 8kk+7] in pairs
    uint32_t pa[4][4];
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int i = (e >> 1) & 1;
      const __nv_bfloat162 p2 = __floats2bfloat162_rn(
          ex2(s[e] - m_use[i]), ex2(s[e + 1] - m_use[i]));
      l[i] += __low2float(p2) + __high2float(p2);
      pa[e >> 3][(e >> 1) & 3] = *reinterpret_cast<const uint32_t*>(&p2);
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[nb][e] *= alpha[(e >> 1) & 1];

    // O += P V: keys 16kk..16kk+15 (two 8-row atoms), 64 columns per nb
    if (wg == 1) named_sync(2);     // after warpgroup 0's PV product
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        wgmma_rs_tb(o[nb], pa[kk],
                    sdesc(vs + nb * (kBK * 128) + kk * 2048, kBK * 128,
                          1024));
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) reg_fence(o[nb]);
    if (wg == 0) named_arrive(2);
  }

  // out = O / l, rounded once to bf16
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float den = fmaxf(quad_sum(l[i]), 1e-30f);
    if (!live[i]) continue;
    const float inv = 1.f / den;
    const int r = wg * 64 + warp * 16 + (lane >> 2) + 8 * i;
    uint16_t* orow = out + (static_cast<int64_t>(b) * s_len + qrow[i]) * tok +
                     static_cast<int64_t>(kvh * g + g0 + r % g_blk) * DH;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = nb * 64 + 8 * c + 2 * (lane & 3);
        if (col < DH)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[nb][4 * c + 2 * i] * inv,
                                    o[nb][4 * c + 2 * i + 1] * inv);
      }
  }
}

template <int DH>
cudaError_t launch(void* out, const void* q, const void* k, const void* v,
                   int b, int s, int sk, int q_off, int h, int kh, int g_blk,
                   int bq, int window, float softcap, float scale, int smem,
                   cudaStream_t stream) {
  const int g = h / kh;
  if (smem < Tile<DH>::SMEM || g_blk < 1 || bq < 1 || g_blk * bq > kRows ||
      q_off < 0 || static_cast<long long>(q_off) + s > sk)
    return cudaErrorInvalidValue;
  const int n_qblk = (s + bq - 1) / bq, n_grp = (g + g_blk - 1) / g_blk;
  const long long blocks = static_cast<long long>(n_qblk) * n_grp * b * kh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  flash_fwd_wgmma<DH><<<static_cast<unsigned>(blocks), kThreads, smem,
                        stream>>>(
      static_cast<uint16_t*>(out), static_cast<const uint16_t*>(q),
      static_cast<const uint16_t*>(k), static_cast<const uint16_t*>(v), s, sk,
      q_off, h, kh, b * kh, g_blk, bq, n_qblk, n_grp, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace

// query rows q_off .. q_off + s - 1 of a sequence of sk keys
extern "C" int flash_attention_wgmma_fwd_rows(void* out, const void* q,
                                              const void* k, const void* v,
                                              int b, int s, int sk, int q_off,
                                              int h, int kh, int dh,
                                              int g_blk, int bq, int window,
                                              float softcap, float scale,
                                              int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dh) {
#define CASE(D)                                                              \
  case D:                                                                    \
    err = launch<D>(out, q, k, v, b, s, sk, q_off, h, kh, g_blk, bq, window, \
                    softcap, scale, smem, st);                               \
    break;
    CASE(32) CASE(64) CASE(112) CASE(128) CASE(256)
#undef CASE
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// a whole sequence: q_off = 0, sk = s
extern "C" int flash_attention_wgmma_fwd(void* out, const void* q,
                                         const void* k, const void* v, int b,
                                         int s, int h, int kh, int dh,
                                         int g_blk, int bq, int window,
                                         float softcap, float scale,
                                         int smem, void* stream) {
  return flash_attention_wgmma_fwd_rows(out, q, k, v, b, s, s, 0, h, kh, dh,
                                        g_blk, bq, window, softcap, scale,
                                        smem, stream);
}
