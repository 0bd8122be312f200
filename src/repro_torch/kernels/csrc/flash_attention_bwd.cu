// Flash attention backward (causal or not, grouped-query) for NVIDIA Hopper
// (sm_90a): the gradients of csrc/flash_attention.cu's forward.
//
// The TPU kernel src/repro/kernels/flash_attention.py (_flash_kernel) has no
// VJP, so the reference trains through its plain attention (_sdpa); the
// port always takes the flash kernel and needs its backward. For q (B, H, S,
// D), k, v (B, Hkv, S, D), the forward's output o and per-row log-sum-exp
// lse = m + log(l) (f32, (B, H, S), natural log of the scaled scores), and
// the output's gradient do, with s = scale * q k^T and P = exp(s - lse):
//
//     delta = rowsum(do * o)                 (f32, the preprocess kernel)
//     dS    = P * (do v^T - delta)
//     dv    = sum over the group's heads of P^T do
//     dk    = scale * sum over the group's heads of dS^T q
//     dq    = scale * dS k
//
// FlashAttention-2's split, with no float atomics: one kernel owns a tile of
// keys of one kv head and loops over the query heads of its group and the
// query tiles at or below the diagonal (dk, dv); another owns a tile of
// queries and loops over the key tiles (dq). Each output element has one
// owner and sums in a fixed order, so two runs on the same inputs give the
// same bits, and GQA's dk and dv need no second pass.
//
// Bound. At the serving path's prefill shape (B=4, S=4096, H=56, Hkv=8,
// D=128, bf16, causal) the five products take 2.5 times the forward's
// 962 GFLOP, 2,406 GFLOP: 2.43 ms at the H100's 989 TFLOP/s for bf16 tensor
// cores; q, k, v, o, do, dq, dk, dv are 1.2 GB, 0.36 ms at 3.35 TB/s. The
// backward is bound by operations.
//
// Design (simple and right first; wgmma and TMA are a later step):
//   * bf16 (D padded to a bucket of 64, 128 or 256): mma.sync m16n8k16,
//     four warps of 16 rows, operands staged by cp.async into padded shared
//     rows and read by ldmatrix, the next tile loading under the products.
//     The recomputed P and dS stay in registers, where the accumulator of
//     one product is the A fragment of the next (rounded to bf16 pairs). At
//     D = 256 a block owns 128 of the output columns (grid.z) and recomputes
//     P and dS for each half, so the accumulators stay in registers.
//   * f32: CUDA cores in exact f32, tiles of 32 keys and 32 queries staged
//     in shared memory; right, not fast (the small float32 runs).
//
// Inputs are read through (b, h, s) strides with a dense last dim, so the
// model-layout (B, S, H, D) views go in as they are. The C entry point
// launches on the caller's stream, allocates nothing (delta is the caller's
// (B, H, S) f32 scratch) and returns a nonzero code when a launch fails.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;  // four warps, every kernel

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  const float* lse;  // (B, H, S), contiguous
  float* delta;      // (B, H, S), contiguous, written by the preprocess
  // (batch, head, sequence) strides in elements; the last dims are dense
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss, do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  int B, H, Hkv, S, D;
  float scale;
  int causal;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(uint16_t x) {  // bf16 bits
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// preprocess: delta[b, h, i] = sum_d do[b, h, i, d] * o[b, h, i, d] in f32,
// one warp per row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) delta_kernel(const BwdParams p) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  if (row >= p.S) return;
  const T* o = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh + row * p.o_ss;
  const T* d = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh +
               row * p.do_ss;
  float acc = 0.f;
  for (int c = lane; c < p.D; c += 32) acc = fmaf(to_f32(o[c]), to_f32(d[c]), acc);
  acc = warp_sum(acc);
  if (lane == 0) p.delta[static_cast<size_t>(blockIdx.y) * p.S + row] = acc;
}

// ---------------------------------------------------------------------------
// f32: CUDA cores. Tiles of kF keys and kF queries in shared memory (rows
// padded to DP + 1 floats, so lanes that read different rows hit different
// banks). A tile's P and dS (kF x kF) go through shared memory; each thread
// owns DP / 4 fixed elements of every accumulated output tile.
// ---------------------------------------------------------------------------

constexpr int kF = 32;

template <int DP>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (4 * kF * (DP + 1) + 2 * kF * (kF + 1) + 2 * kF);
}

// P and dS of the tile pairs: key kF-row tile ks/vs against query tile
// qs/dos; lane j scores key j against the warp's rows w, w + 4, ...
template <int DP>
__device__ __forceinline__ void f32_scores(const BwdParams& p, const float* qs,
                                           const float* dos, const float* ks,
                                           const float* vs, const float* lse_s,
                                           const float* delta_s, int q0, int k0,
                                           float* ps, float* dss) {
  constexpr int LD = DP + 1;
  const int j = threadIdx.x % 32, w = threadIdx.x / 32;
#pragma unroll 1
  for (int i = 0; i < kF / 4; ++i) {
    const int r = w + 4 * i;
    float s = 0.f, dp = 0.f;
    for (int c = 0; c < DP; ++c) {
      s = fmaf(qs[r * LD + c], ks[j * LD + c], s);
      dp = fmaf(dos[r * LD + c], vs[j * LD + c], dp);
    }
    const int qi = q0 + r, kj = k0 + j;
    const bool valid = qi < p.S && kj < p.S && (!p.causal || kj <= qi);
    const float pr = valid ? expf(s * p.scale - lse_s[r]) : 0.f;
    if (ps != nullptr) ps[r * (kF + 1) + j] = pr;
    dss[r * (kF + 1) + j] = pr * (dp - delta_s[r]);
  }
}

// rows [r0, r0 + kF) of a (b, h) slice into shared rows of DP + 1, zeros
// past S or D
__device__ __forceinline__ void f32_stage(float* dst, const float* src,
                                          long long ss, int r0, int S, int D,
                                          int DP) {
  for (int i = threadIdx.x; i < kF * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    dst[r * (DP + 1) + c] = (r0 + r < S && c < D) ? src[(r0 + r) * ss + c] : 0.f;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) dkdv_f32_kernel(const BwdParams p) {
  constexpr int LD = DP + 1, E = kF * DP / kThreads;
  extern __shared__ float f32_smem[];
  float* ks = f32_smem;
  float* vs = ks + kF * LD;
  float* qs = vs + kF * LD;
  float* dos = qs + kF * LD;
  float* ps = dos + kF * LD;
  float* dss = ps + kF * (kF + 1);
  float* lse_s = dss + kF * (kF + 1);
  float* delta_s = lse_s + kF;

  const int k0 = blockIdx.x * kF;  // the first tiles have the most queries
  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv;
  const int G = p.H / p.Hkv;
  f32_stage(ks, static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh,
            p.k_ss, k0, p.S, p.D, DP);
  f32_stage(vs, static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh,
            p.v_ss, k0, p.S, p.D, DP);

  float dk[E], dv[E];
#pragma unroll
  for (int i = 0; i < E; ++i) dk[i] = dv[i] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* d = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const size_t stat = (static_cast<size_t>(b) * p.H + h) * p.S;
    for (int q0 = p.causal ? k0 : 0; q0 < p.S; q0 += kF) {
      __syncthreads();  // the previous tile is consumed
      f32_stage(qs, q, p.q_ss, q0, p.S, p.D, DP);
      f32_stage(dos, d, p.do_ss, q0, p.S, p.D, DP);
      if (threadIdx.x < kF) {
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < p.S ? p.lse[stat + r] : 0.f;
        delta_s[threadIdx.x] = r < p.S ? p.delta[stat + r] : 0.f;
      }
      __syncthreads();
      f32_scores<DP>(p, qs, dos, ks, vs, lse_s, delta_s, q0, k0, ps, dss);
      __syncthreads();
      // dv += P^T do, dk += dS^T q over the tile's queries
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const int e = threadIdx.x + kThreads * i, j = e / DP, c = e % DP;
        float a = dv[i], bk = dk[i];
        for (int r = 0; r < kF; ++r) {
          a = fmaf(ps[r * (kF + 1) + j], dos[r * LD + c], a);
          bk = fmaf(dss[r * (kF + 1) + j], qs[r * LD + c], bk);
        }
        dv[i] = a;
        dk[i] = bk;
      }
    }
  }

  float* gk = static_cast<float*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
  float* gv = static_cast<float*>(p.dv) + b * p.dv_sb + hk * p.dv_sh;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int e = threadIdx.x + kThreads * i, j = e / DP, c = e % DP;
    if (k0 + j < p.S && c < p.D) {
      gk[(k0 + j) * p.dk_ss + c] = dk[i] * p.scale;
      gv[(k0 + j) * p.dv_ss + c] = dv[i];
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) dq_f32_kernel(const BwdParams p) {
  constexpr int LD = DP + 1, E = kF * DP / kThreads;
  extern __shared__ float f32_smem[];
  float* ks = f32_smem;
  float* vs = ks + kF * LD;
  float* qs = vs + kF * LD;
  float* dos = qs + kF * LD;
  float* dss = dos + kF * LD + kF * (kF + 1);  // (the P tile is not kept)
  float* lse_s = dss + kF * (kF + 1);
  float* delta_s = lse_s + kF;

  const int nq = (p.S + kF - 1) / kF;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kF;  // longest first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  f32_stage(qs, static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh,
            p.q_ss, q0, p.S, p.D, DP);
  f32_stage(dos, static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh,
            p.do_ss, q0, p.S, p.D, DP);
  if (threadIdx.x < kF) {
    const size_t stat = static_cast<size_t>(blockIdx.y) * p.S;
    const int r = q0 + threadIdx.x;
    lse_s[threadIdx.x] = r < p.S ? p.lse[stat + r] : 0.f;
    delta_s[threadIdx.x] = r < p.S ? p.delta[stat + r] : 0.f;
  }

  float dq[E];
#pragma unroll
  for (int i = 0; i < E; ++i) dq[i] = 0.f;
  const int kv_end = p.causal ? min(p.S, q0 + kF) : p.S;
  for (int n0 = 0; n0 < kv_end; n0 += kF) {
    __syncthreads();  // the previous tile is consumed (and q, do are staged)
    f32_stage(ks, k, p.k_ss, n0, p.S, p.D, DP);
    f32_stage(vs, v, p.v_ss, n0, p.S, p.D, DP);
    __syncthreads();
    f32_scores<DP>(p, qs, dos, ks, vs, lse_s, delta_s, q0, n0, nullptr, dss);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int e = threadIdx.x + kThreads * i, r = e / DP, c = e % DP;
      float a = dq[i];
      for (int j = 0; j < kF; ++j) a = fmaf(dss[r * (kF + 1) + j], ks[j * LD + c], a);
      dq[i] = a;
    }
  }

  float* gq = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int e = threadIdx.x + kThreads * i, r = e / DP, c = e % DP;
    if (q0 + r < p.S && c < p.D) gq[(q0 + r) * p.dq_ss + c] = dq[i] * p.scale;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores through mma.sync m16n8k16 (bf16 x bf16 -> f32).
// Fragment layout (PTX ISA, per lane: g = lane / 4, t = lane % 4):
//   A 16x16 row-major: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                      a3 (g+8, 2t+8..)
//   B 16x8 "col":      b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C 16x8 f32:        c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// So the C fragments of two 8-column tiles, packed pairwise, are the A
// fragment of one 16-deep step.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, and r[i] is its fragment (row g, cols 2t..2t+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// The same, transposed: r[i] holds (rows 2t..2t+1, col g) of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// 16 bytes from device to shared memory, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + R) of a (b, h) slice into shared rows of LD bf16, by
// cp.async, zeros past S or D (D is a multiple of 8: a 16-byte chunk is all
// in or all out).
template <int R, int DP>
__device__ __forceinline__ void bf16_stage(uint16_t* dst, const uint16_t* src,
                                           long long ss, int r0, int S, int D) {
  constexpr int VPR = DP / 8, LD = DP + 8;
  for (int i = threadIdx.x; i < R * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool in = r0 + r < S && c < D;
    cp_async16(dst + r * LD + c, in ? src + (r0 + r) * ss + c : src, in);
  }
}

// A fragment of rows [row0, row0 + 16) and columns [col, col + 16) of a
// shared tile whose rows are LD apart.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint16_t* tile,
                                       int LD, int row0, int col) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(a, tile + (row0 + (lane & 15)) * LD + col + (lane >> 4) * 8);
}

// B fragments of two 8-row tiles n, n + 1 of a shared tile (rows are the
// product's n dimension, columns its k dimension [col, col + 16)):
// b[0], b[1] for tile n and b[2], b[3] for tile n + 1.
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const uint16_t* tile,
                                       int LD, int n, int col) {
  const int lane = threadIdx.x % 32, mi = lane >> 3, mr = lane & 7;
  ldmatrix_x4(b, tile + ((n + (mi >> 1)) * 8 + mr) * LD + col + (mi & 1) * 8);
}

// B fragments where the shared rows are the k dimension [row, row + 16) and
// the columns the n dimension: 8-column tiles at col and col + 8.
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4],
                                             const uint16_t* tile, int LD,
                                             int row, int col) {
  const int lane = threadIdx.x % 32, mi = lane >> 3, mr = lane & 7;
  ldmatrix_x4_trans(b, tile + (row + (mi & 1) * 8 + mr) * LD + col + (mi >> 1) * 8);
}

// A fragment of a 16-deep step kc from two C-fragment tiles 2kc, 2kc + 1.
template <int N>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c)[N][4],
                                       int kc) {
  a[0] = pack_bf16(c[2 * kc][0], c[2 * kc][1]);
  a[1] = pack_bf16(c[2 * kc][2], c[2 * kc][3]);
  a[2] = pack_bf16(c[2 * kc + 1][0], c[2 * kc + 1][1]);
  a[3] = pack_bf16(c[2 * kc + 1][2], c[2 * kc + 1][3]);
}

// Two products of one 16-row warp tile against NT 8-column tiles, sharing
// their depth DP: s = A1 B1^T and dp = A2 B2^T, with A1, A2 rows [row0,
// row0 + 16) of a1, a2 and B1, B2 the rows of b1, b2.
template <int DP, int NT>
__device__ __forceinline__ void two_products(float (&s)[NT][4],
                                             float (&dp)[NT][4],
                                             const uint16_t* a1,
                                             const uint16_t* a2, int row0,
                                             const uint16_t* b1,
                                             const uint16_t* b2) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
  }
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) {
    uint32_t x[4], y[4];
    load_a(x, a1, LD, row0, kc * 16);
    load_a(y, a2, LD, row0, kc * 16);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t bx[4], by[4];
      load_b(bx, b1, LD, n, kc * 16);
      load_b(by, b2, LD, n, kc * 16);
      mma_bf16(s[n], x, bx[0], bx[1]);
      mma_bf16(s[n + 1], x, bx[2], bx[3]);
      mma_bf16(dp[n], y, by[0], by[1]);
      mma_bf16(dp[n + 1], y, by[2], by[3]);
    }
  }
}

// dQ: a block owns 64 query rows of one (b, h) (16 per warp) and DC of the
// output's columns; k/v tiles of 32 keys, two in flight.
constexpr int kQBM = 64, kQBN = 32;
// dK/dV: a block owns 64 keys of one (b, kv head) (16 per warp) and DC of
// the outputs' columns; q/do tiles of 32 queries, two in flight.
constexpr int kKBN = 64, kKBM = 32;

template <int DP>
constexpr size_t dq_smem_bytes() {
  return sizeof(uint16_t) * (2 * kQBM + 4 * kQBN) * (DP + 8);
}

template <int DP>
constexpr size_t dkdv_smem_bytes() {
  return sizeof(uint16_t) * (2 * kKBN + 4 * kKBM) * (DP + 8) +
         sizeof(float) * 4 * kKBM;
}

template <int DP, int DC>
__global__ void __launch_bounds__(kThreads) dq_bf16_kernel(const BwdParams p) {
  constexpr int BM = kQBM, BN = kQBN, LD = DP + 8, NT = BN / 8, DT = DC / 8;
  extern __shared__ __align__(16) uint16_t bf16_smem[];
  uint16_t* qs = bf16_smem;
  uint16_t* dos = qs + BM * LD;
  uint16_t* kv = dos + BM * LD;  // two stages of (k, v)

  const int nq = (p.S + BM - 1) / BM;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BM;  // longest first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int c0 = blockIdx.z * DC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const uint16_t* k = static_cast<const uint16_t*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const uint16_t* v = static_cast<const uint16_t*>(p.v) + b * p.v_sb + hk * p.v_sh;

  auto load_tile = [&](int n0, int buf) {
    uint16_t* kd = kv + buf * 2 * BN * LD;
    bf16_stage<BN, DP>(kd, k, p.k_ss, n0, p.S, p.D);
    bf16_stage<BN, DP>(kd + BN * LD, v, p.v_ss, n0, p.S, p.D);
    cp_async_commit();
  };
  // q and do join the first tile's group
  bf16_stage<BM, DP>(qs, static_cast<const uint16_t*>(p.q) + b * p.q_sb + h * p.q_sh,
                     p.q_ss, q0, p.S, p.D);
  bf16_stage<BM, DP>(dos, static_cast<const uint16_t*>(p.dout) + b * p.do_sb +
                              h * p.do_sh, p.do_ss, q0, p.S, p.D);
  const int kv_end = p.causal ? min(p.S, q0 + BM) : p.S;
  const int n_tiles = (kv_end + BN - 1) / BN;
  load_tile(0, 0);

  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
  const size_t stat = static_cast<size_t>(blockIdx.y) * p.S;
  const float lse_lo = r_lo < p.S ? p.lse[stat + r_lo] * kLog2e : 0.f;
  const float lse_hi = r_hi < p.S ? p.lse[stat + r_hi] * kLog2e : 0.f;
  const float dl_lo = r_lo < p.S ? p.delta[stat + r_lo] : 0.f;
  const float dl_hi = r_hi < p.S ? p.delta[stat + r_hi] : 0.f;
  const float sl2 = p.scale * kLog2e;

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int n0 = it * BN;
    if (it + 1 < n_tiles) {  // the next tile flies in while this one is used
      load_tile(n0 + BN, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint16_t* kb = kv + (it & 1) * 2 * BN * LD;
    const uint16_t* vb = kb + BN * LD;

    // s = q k^T, dp = do v^T: 16 rows x BN keys
    float s[NT][4], dp[NT][4];
    two_products<DP, NT>(s, dp, qs, dos, warp * 16, kb, vb);

    // P = exp(s - lse) (0 where masked), dS = P (dp - delta), in place
    const bool edge = n0 + BN > p.S || (p.causal && n0 + BN - 1 > q0 + warp * 16);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e & 2;
        float x = exp2f(s[n][e] * sl2 - (hi ? lse_hi : lse_lo));
        if (edge) {
          const int key = n0 + n * 8 + 2 * t + (e & 1);
          if (key >= p.S || (p.causal && key > (hi ? r_hi : r_lo))) x = 0.f;
        }
        dp[n][e] = x * (dp[n][e] - (hi ? dl_hi : dl_lo));
      }
    }

    // dq += dS k over the tile's keys
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t a[4];
      c_to_a(a, dp, kc);
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        uint32_t bk[4];
        load_b_trans(bk, kb, LD, kc * 16, c0 + d * 8);
        mma_bf16(acc[d], a, bk[0], bk[1]);
        mma_bf16(acc[d + 1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();  // this buffer is free for the tile after next
  }

  uint16_t* gq = static_cast<uint16_t*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int c = c0 + d * 8 + 2 * t;
    if (c >= p.D) continue;
    if (r_lo < p.S) {
      *reinterpret_cast<uint32_t*>(gq + r_lo * p.dq_ss + c) =
          pack_bf16(acc[d][0] * p.scale, acc[d][1] * p.scale);
    }
    if (r_hi < p.S) {
      *reinterpret_cast<uint32_t*>(gq + r_hi * p.dq_ss + c) =
          pack_bf16(acc[d][2] * p.scale, acc[d][3] * p.scale);
    }
  }
}

template <int DP, int DC>
__global__ void __launch_bounds__(kThreads) dkdv_bf16_kernel(const BwdParams p) {
  constexpr int BN = kKBN, BM = kKBM, LD = DP + 8, NT = BM / 8, DT = DC / 8;
  extern __shared__ __align__(16) uint16_t bf16_smem[];
  uint16_t* ks = bf16_smem;
  uint16_t* vs = ks + BN * LD;
  uint16_t* qd = vs + BN * LD;  // two stages of (q, do)
  float* stats = reinterpret_cast<float*>(qd + 4 * BM * LD);  // two of (lse, delta)

  const int k0 = blockIdx.x * BN;  // the first tiles have the most queries
  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv;
  const int G = p.H / p.Hkv;
  const int c0 = blockIdx.z * DC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  // the steps: every query tile at or below the diagonal, for each query
  // head of the group in turn
  const int first = p.causal ? k0 / BM : 0;
  const int nt = (p.S + BM - 1) / BM - first;
  const int steps = G * nt;
  auto load_step = [&](int it, int buf) {
    const int h = hk * G + it / nt, q0 = (first + it % nt) * BM;
    uint16_t* qb = qd + buf * 2 * BM * LD;
    bf16_stage<BM, DP>(qb, static_cast<const uint16_t*>(p.q) + b * p.q_sb +
                               h * p.q_sh, p.q_ss, q0, p.S, p.D);
    bf16_stage<BM, DP>(qb + BM * LD, static_cast<const uint16_t*>(p.dout) +
                                         b * p.do_sb + h * p.do_sh,
                       p.do_ss, q0, p.S, p.D);
    if (threadIdx.x < BM) {
      const size_t stat = (static_cast<size_t>(b) * p.H + h) * p.S;
      const int r = q0 + threadIdx.x;
      float* st = stats + buf * 2 * BM;
      st[threadIdx.x] = r < p.S ? p.lse[stat + r] * kLog2e : 0.f;
      st[BM + threadIdx.x] = r < p.S ? p.delta[stat + r] : 0.f;
    }
    cp_async_commit();
  };
  // k and v join the first step's group
  bf16_stage<BN, DP>(ks, static_cast<const uint16_t*>(p.k) + b * p.k_sb + hk * p.k_sh,
                     p.k_ss, k0, p.S, p.D);
  bf16_stage<BN, DP>(vs, static_cast<const uint16_t*>(p.v) + b * p.v_sb + hk * p.v_sh,
                     p.v_ss, k0, p.S, p.D);
  load_step(0, 0);

  const int key_lo = k0 + warp * 16 + g, key_hi = key_lo + 8;
  const float sl2 = p.scale * kLog2e;
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;
  }

  for (int it = 0; it < steps; ++it) {
    if (it + 1 < steps) {  // the next step flies in while this one is used
      load_step(it + 1, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (first + it % nt) * BM;
    const uint16_t* qb = qd + (it & 1) * 2 * BM * LD;
    const uint16_t* db = qb + BM * LD;
    const float* st = stats + (it & 1) * 2 * BM;

    // s^T = k q^T, dp^T = v do^T: 16 keys x BM queries
    float s[NT][4], dp[NT][4];
    two_products<DP, NT>(s, dp, ks, vs, warp * 16, qb, db);

    // P^T = exp(s^T - lse) (0 where masked), dS^T = P^T (dp^T - delta)
    const bool edge = q0 + BM > p.S || (p.causal && q0 < k0 + warp * 16 + 15);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);  // the query within the tile
        float x = exp2f(s[n][e] * sl2 - st[col]);
        if (edge) {
          const int query = q0 + col;
          if (query >= p.S || (p.causal && query < ((e & 2) ? key_hi : key_lo))) x = 0.f;
        }
        s[n][e] = x;
        dp[n][e] = x * (dp[n][e] - st[BM + col]);
      }
    }

    // dv += P^T do, dk += dS^T q over the tile's queries
#pragma unroll
    for (int kc = 0; kc < BM / 16; ++kc) {
      uint32_t pa[4], da[4];
      c_to_a(pa, s, kc);
      c_to_a(da, dp, kc);
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        uint32_t bo[4], bq[4];
        load_b_trans(bo, db, LD, kc * 16, c0 + d * 8);
        load_b_trans(bq, qb, LD, kc * 16, c0 + d * 8);
        mma_bf16(dv[d], pa, bo[0], bo[1]);
        mma_bf16(dv[d + 1], pa, bo[2], bo[3]);
        mma_bf16(dk[d], da, bq[0], bq[1]);
        mma_bf16(dk[d + 1], da, bq[2], bq[3]);
      }
    }
    __syncthreads();  // this stage is free for the step after next
  }

  uint16_t* gk = static_cast<uint16_t*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
  uint16_t* gv = static_cast<uint16_t*>(p.dv) + b * p.dv_sb + hk * p.dv_sh;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int c = c0 + d * 8 + 2 * t;
    if (c >= p.D) continue;
    if (key_lo < p.S) {
      *reinterpret_cast<uint32_t*>(gk + key_lo * p.dk_ss + c) =
          pack_bf16(dk[d][0] * p.scale, dk[d][1] * p.scale);
      *reinterpret_cast<uint32_t*>(gv + key_lo * p.dv_ss + c) =
          pack_bf16(dv[d][0], dv[d][1]);
    }
    if (key_hi < p.S) {
      *reinterpret_cast<uint32_t*>(gk + key_hi * p.dk_ss + c) =
          pack_bf16(dk[d][2] * p.scale, dk[d][3] * p.scale);
      *reinterpret_cast<uint32_t*>(gv + key_hi * p.dv_ss + c) =
          pack_bf16(dv[d][2], dv[d][3]);
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   const BwdParams& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_f32(const BwdParams& p, cudaStream_t s) {
  constexpr size_t smem = f32_smem_bytes<DP>();
  const int n = (p.S + kF - 1) / kF;
  cudaError_t err = launch(dkdv_f32_kernel<DP>, dim3(n, p.B * p.Hkv), smem, s, p);
  if (err != cudaSuccess) return err;
  return launch(dq_f32_kernel<DP>, dim3(n, p.B * p.H), smem, s, p);
}

template <int DP>
cudaError_t launch_bf16(const BwdParams& p, cudaStream_t s) {
  constexpr int DC = DP < 128 ? DP : 128;
  const dim3 kv_grid((p.S + kKBN - 1) / kKBN, p.B * p.Hkv, DP / DC);
  cudaError_t err = launch(dkdv_bf16_kernel<DP, DC>, kv_grid,
                           dkdv_smem_bytes<DP>(), s, p);
  if (err != cudaSuccess) return err;
  const dim3 q_grid((p.S + kQBM - 1) / kQBM, p.B * p.H, DP / DC);
  return launch(dq_bf16_kernel<DP, DC>, q_grid, dq_smem_bytes<DP>(), s, p);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, do, dq, dk, dv alike).
// strides holds the (batch, head, sequence) strides in elements of q, k, v,
// o, do, dq, dk and dv, in that order; each last dim is dense. lse is the
// forward's (B, H, S) f32 log-sum-exp, delta a (B, H, S) f32 scratch. The
// caller guarantees 1 <= S, H % Hkv == 0, B * H <= 65535, D % 8 == 0 with
// 8 <= D <= 256, and (for bf16) 16-byte aligned rows.
int flash_attention_bwd_launch(int dtype, const void* q, const void* k,
                               const void* v, const void* o, const void* dout,
                               void* dq, void* dk, void* dv, const float* lse,
                               float* delta, const long long* strides, int B,
                               int H, int Hkv, int S, int D, float scale,
                               int causal, void* stream) {
  if ((dtype != 0 && dtype != 1) || D < 8 || D > 256 || D % 8 != 0 || S < 1 ||
      Hkv < 1 || H % Hkv != 0 || B * H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.lse = lse;
  p.delta = delta;
  long long* st[24] = {&p.q_sb,  &p.q_sh,  &p.q_ss,  &p.k_sb,  &p.k_sh,  &p.k_ss,
                       &p.v_sb,  &p.v_sh,  &p.v_ss,  &p.o_sb,  &p.o_sh,  &p.o_ss,
                       &p.do_sb, &p.do_sh, &p.do_ss, &p.dq_sb, &p.dq_sh, &p.dq_ss,
                       &p.dk_sb, &p.dk_sh, &p.dk_ss, &p.dv_sb, &p.dv_sh, &p.dv_ss};
  for (int i = 0; i < 24; ++i) *st[i] = strides[i];
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.S = S;
  p.D = D;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 rows((S + kThreads / 32 - 1) / (kThreads / 32), B * H);
  cudaError_t err = dtype == 1 ? launch(delta_kernel<uint16_t>, rows, 0, s, p)
                               : launch(delta_kernel<float>, rows, 0, s, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 1) {  // bf16: the kernels are chosen by D alone
    if (D <= 64) err = launch_bf16<64>(p, s);
    else if (D <= 128) err = launch_bf16<128>(p, s);
    else err = launch_bf16<256>(p, s);
  } else if (D <= 32) {
    err = launch_f32<32>(p, s);
  } else if (D <= 64) {
    err = launch_f32<64>(p, s);
  } else if (D <= 128) {
    err = launch_f32<128>(p, s);
  } else {
    err = launch_f32<256>(p, s);
  }
  return static_cast<int>(err);
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
