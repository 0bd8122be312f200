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
// Bound. At the serving path's prefill shape (B=4, S=4096, H=56, Hkv=8,
// D=128, bf16, causal) the five products take 2.5 times the forward's
// 962 GFLOP, 2,406 GFLOP: 2.43 ms at the H100's 989 TFLOP/s for bf16 tensor
// cores; q, k, v, o, do, dq, dk, dv are 1.2 GB, 0.36 ms at 3.35 TB/s. The
// backward is bound by operations.
//
// The entry point picks the kernels by (dtype, D) alone, as the forward's
// does; no error is caught and retried another way.
//
// bf16, D <= 128 (every dense config of the zoo: D = 128, or 120 padded to
// 128; D <= 64 pads to 64): FlashAttention-3's backward (Shah et al., 2024,
// arXiv:2407.08608, section 3) in its deterministic form, three launches:
//   1. stats_kernel: (lse * log2(e), delta) per query row, padded to whole
//      64-row tiles (bytes-bound, 16-byte loads, a half-warp a row);
//   2. bwd_bf16_wgmma_kernel: one pass for dK, dV and dQ, five products:
//        - a block owns 128 keys of one (b, kv head) and walks the query
//          heads of its group and, within each, the 64-query tiles at or
//          below the diagonal, in order; dK and dV stay in registers over
//          the whole walk, so GQA's group sum is one block's, in a fixed
//          order, with no second pass;
//        - 256 threads, two warpgroups of 64 keys each (wgmma's M). Thread
//          0 also issues every TMA load: k and v once, then q, do and their
//          stats rows two steps ahead, through a two-stage ring behind full
//          mbarriers; thread 128 also writes dQ (below). No producer
//          warpgroup: with more than 256 threads ptxas gives a thread at
//          most 168 registers, and under setmaxnreg's split 200 (measured
//          on this kernel), fewer than the products need;
//        - per step, with wgmma: S^T = K Q^T and dP^T = V dO^T (both
//          operands in shared memory, 128-byte swizzled as TMA writes
//          them), both in flight; P^T and dS^T in registers, where the
//          accumulators are the next products' A fragments: dV += P^T dO
//          and dK += dS^T Q (q and do read MN-major); dS^T also staged in
//          shared memory (bf16, two buffers), and dQ = dS K with both
//          operands read MN-major, each warpgroup taking 64 of dQ's columns
//          (D = 128; at D <= 64 each takes its own 64 keys, and the two
//          partial sums are added in shared memory);
//        - dQ without float atomics in an unordered way: the partial sums
//          of a step go to shared memory, and thread 128 adds them into an
//          f32 workspace tile of (b, h, query tile) by a bulk reduce-add,
//          in turn: a per-tile counter (zero before the launch) says how
//          many key tiles have added theirs, and a block waits until it is
//          its turn. So every dQ element sums its key tiles in one fixed
//          order and two runs give the same bits. The first contributor
//          stores instead of adding, so the workspace needs no fill. The
//          counter is read under the step's dV, dK and dQ products, and a
//          step's turn is passed on at the end of the next step, when its
//          add has long completed (waiting for the add within a step
//          stalls: it takes more than half a step);
//        - the turns run from the highest key tile down to key tile 0, and
//          blockIdx.x walks the key tiles from the highest down: a block
//          waits only on lower-numbered blocks of its (b, kv head), which
//          were launched before it and so are running or done, and the
//          wait always makes progress. In this order a block's predecessor
//          (the next key tile up) has fewer query tiles and reaches each
//          tile two steps earlier, so in the causal case a block rarely
//          waits; the other order (key tile 0 first) would pace every
//          block by key tile 0, idling about half of the card;
//        - a lost turn traps after 10 s, as a lost mbarrier phase does, so
//          a fault fails the launch instead of hanging the card;
//        - the mask is one branch per warpgroup and step, taken only where
//          the tile crosses the diagonal or S; rows past S and columns past
//          D come back from TMA as zeros, and dK and dV are staged in
//          shared memory and stored by TMA, which writes only rows below S
//          and columns below D;
//   3. dq_convert_kernel: dq = scale * workspace, in q's dtype and layout
//      (bytes-bound). With key tile 0 the last of every turn, its block,
//      the longest, would otherwise convert every tile on the critical
//      path.
// Registers: a thread holds dV and dK (D/2 f32 each), the S^T and dP^T
// accumulators (32 f32 each), then P^T and dS^T (16 bf16x2 each) and its
// dQ partial (32 f32): ptxas uses ~244 of the 255 a 256-thread block
// allows, with no spill (build.py passes -Xptxas -v; a spill makes ptxas
// serialise every wgmma). Shared memory: k and v (128 x 128 bf16 each),
// the q/do ring (two stages of 64 x 128 bf16 each), dS^T (two of 128 x 64
// bf16), the dQ partial (64 x 128 f32) and the stats: 194 KB at D = 128,
// one block an SM. The workspace is (B, H, ceil(S / 64) tiles, 64 x DP)
// f32, 470 MB at the prefill shape.
//
// bf16, 128 < D <= 256 (no config reaches it): FlashAttention-2's split
// with mma.sync m16n8k16, four warps of 16 rows, cp.async into padded rows
// and ldmatrix: one kernel for dK/dV (a key tile of one kv head, looping
// over its group's heads and query tiles) and one for dQ (a query tile,
// looping over key tiles), each output with one owner; a block owns 128 of
// the output columns (grid.z) and recomputes P and dS for each half.
// f32: the same split on CUDA cores in exact f32, tiles of 32 keys and 32
// queries staged in shared memory; right, not fast (the small float32
// runs).
//
// Inputs are read through (b, h, s) strides with a dense last dim, so the
// model-layout (B, S, H, D) views go in as they are. The C entry point
// launches on the caller's stream, allocates nothing (the statistics, the
// dQ workspace and the turn counters are the caller's) and returns a
// nonzero code when a tensor map cannot be encoded or a launch fails.

#include <stdio.h>

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// bf16, D <= 128: TMA, an mbarrier ring, warp specialisation and wgmma (the
// design is in the note at the top).
// ---------------------------------------------------------------------------

constexpr int kHBN = 128;         // keys per block, 64 per consumer
constexpr int kHBM = 64;          // queries per step
constexpr int kHStages = 2;       // depth of the q/do ring
constexpr int kHThreads = 256;    // two warpgroups, 64 keys each
constexpr int kStatRows = 16;     // rows per block of stats_kernel
constexpr uint32_t kStatBytes = kHBM * 8;          // (lse2, delta) per query
constexpr uint32_t kKBox = kHBN * kBoxRowBytes;    // one box of a k/v tile
constexpr uint32_t kQBox = kHBM * kBoxRowBytes;    // one box of a q/do tile
constexpr uint32_t kDsBytes = kHBN * kHBM * 2;     // dS^T: keys x queries

template <int DP>
struct HLayout {
  static constexpr int boxes = DP / kBoxCols;
  static constexpr uint32_t kv_bytes = kHBN * DP * 2;  // one k or v tile
  static constexpr uint32_t qt_bytes = kHBM * DP * 2;  // one q or do tile
  static constexpr uint32_t dq_bytes = kHBM * DP * 4;  // the dQ partial
  static constexpr uint32_t k_off = 0;
  static constexpr uint32_t v_off = kv_bytes;
  static constexpr uint32_t q_off = 2 * kv_bytes;
  static constexpr uint32_t do_off = q_off + kHStages * qt_bytes;
  static constexpr uint32_t ds_off = do_off + kHStages * qt_bytes;
  static constexpr uint32_t dq_off = ds_off + 2 * kDsBytes;
  static constexpr uint32_t st_off = dq_off + dq_bytes;
  static constexpr uint32_t bar_off = st_off + kHStages * kStatBytes;
  // k/v full; per stage: full
  static constexpr int n_bars = 1 + kHStages;
  static constexpr size_t smem = bar_off + 8 * n_bars + 1024;  // + alignment
};

struct HParams {
  int S, H, Hkv, group, nqt, nkt, causal;
  float scale;
  float sl2;            // scale * log2(e): scores go to the log2 domain
  const float* stats;   // (B, H, nqt * 64) pairs (lse * log2(e), delta)
  float* ws;            // (B, H, nqt) tiles of 64 x DP f32: dQ's sums
  int* turns;           // (B, H, nqt): key tiles added so; zero at launch
};

// (lse * log2(e), delta = rowsum(do * o)) of every query row, zeros on the
// rows that pad S to whole tiles: a half-warp a row, 8 columns a lane.
__global__ void __launch_bounds__(32 * kStatRows / 2) stats_kernel(
    const BwdParams p, float2* stats, int s_pad) {
  const int row = blockIdx.x * kStatRows + threadIdx.x / 16;
  const int l = threadIdx.x % 16;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  float acc = 0.f;
  if (row < p.S && 8 * l < p.D) {
    const uint4 x = *reinterpret_cast<const uint4*>(
        static_cast<const uint16_t*>(p.o) + b * p.o_sb + h * p.o_sh +
        row * p.o_ss + 8 * l);
    const uint4 y = *reinterpret_cast<const uint4*>(
        static_cast<const uint16_t*>(p.dout) + b * p.do_sb + h * p.do_sh +
        row * p.do_ss + 8 * l);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc = fmaf(__uint_as_float(xs[i] << 16), __uint_as_float(ys[i] << 16), acc);
      acc = fmaf(__uint_as_float(xs[i] & 0xFFFF0000u),
                 __uint_as_float(ys[i] & 0xFFFF0000u), acc);
    }
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (l == 0) {
    stats[static_cast<size_t>(bh) * s_pad + row] =
        row < p.S ? make_float2(p.lse[static_cast<size_t>(bh) * p.S + row] * kLog2e, acc)
                  : make_float2(0.f, 0.f);
  }
}

__device__ __forceinline__ float4 ld_shared_v4(uint32_t addr) {
  float4 x;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(addr));
  return x;
}

__device__ __forceinline__ void st_shared_v2(uint32_t addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a),
               "f"(b)
               : "memory");
}

__device__ __forceinline__ float2 ld_shared_v2(uint32_t addr) {
  float2 x;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(x.x), "=f"(x.y)
               : "r"(addr));
  return x;
}

// Byte offset of (row r, column c) in a dQ tile of 64 rows x DP f32 (the
// consumers' partial in shared memory, and a workspace tile, which the
// bulk add copies byte for byte): rows of DP floats, the 16-byte chunk of
// columns c / 4 of row r at chunk (c / 4) ^ (r % 8), so the consumers'
// stores (eight rows a warp) fall in distinct banks and the conversion
// reads whole rows.
template <int DP>
__device__ __forceinline__ uint32_t dq_at(int r, int c) {
  return r * DP * 4 + (((c >> 2) ^ (r & 7)) << 4) + (c & 3) * 4;
}

// bytes from device memory into shared memory, reported to the mbarrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(float* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   dst),
               "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src,
                                                uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32"
      " [%0], [%1], %2;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int x;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(x)
               : "l"(p)
               : "memory");
  return x;
}

__device__ __forceinline__ void st_release(int* p, int x) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(x)
               : "memory");
}

// Wait until the tile's counter reaches this block's turn (trap after 10 s:
// a turn that never comes is a fault).
__device__ __forceinline__ void wait_turn(const int* counter, int turn) {
  if (ld_acquire(counter) == turn) return;
  const uint64_t t0 = global_ns();
  while (ld_acquire(counter) != turn) {
    if (global_ns() - t0 > kLostNs) __trap();
    __nanosleep(32);
  }
}

// D (64 x 64, f32) (+)= A (64 x 16, shared) B (16 x 64, shared); TA, TB
// say whether A and B are read MN-major (transposed) or K-major. The first
// k-step of a product writes D without reading it ("=f"), so the compiler
// keeps no earlier value of D alive; the rest accumulate ("+f").
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_first(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// S^T = K Q^T (or dP^T = V dO^T) of one step: the warpgroup's 64 rows of
// the k (v) tile at kw against the 64 rows of the q (do) tile at qt, D/16
// steps of k16: within a 64-column box a step advances 32 bytes, past it a
// box. Issued and committed as one group.
template <int DP>
__device__ __forceinline__ void issue_rows(float (&d)[32], uint32_t kw,
                                           uint32_t qt) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    const uint64_t da = wgmma_desc(kw + (kk / 4) * kKBox + col, 16, 1024);
    const uint64_t db = wgmma_desc(qt + (kk / 4) * kQBox + col, 16, 1024);
    if (kk == 0) {
      wgmma_ss_first<0, 0>(d, da, db);
    } else {
      wgmma_ss<0, 0>(d, da, db);
    }
  }
  wgmma_commit();
}

// dV += P^T dO (or dK += dS^T Q): A from registers (the 64 keys by 16
// queries of each k-step), the q (do) tile at qt the transposed B operand,
// 8 query rows 128 bytes apart, the next 8 at 1024 bytes, the next 64
// columns one box further.
template <int N>
__device__ __forceinline__ void issue_acc(float (&d)[N],
                                          const uint32_t (&a)[16],
                                          uint32_t qt) {
#pragma unroll
  for (int kk = 0; kk < kHBM / 16; ++kk) {
    wgmma_rs(d, a + 4 * kk,
             wgmma_desc(qt + kk * 16 * kBoxRowBytes, kQBox, 1024));
  }
  wgmma_commit();
}

// dQ's partial sums = dS K over KS * 16 keys: dS^T at ds (keys x queries,
// queries contiguous) is A read MN-major, 64 of the k tile's columns at kc
// (keys x D, D contiguous) B read MN-major; both start at the same key row.
template <int KS>
__device__ __forceinline__ void issue_dq(float (&d)[32], uint32_t ds,
                                         uint32_t kc) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const uint64_t da = wgmma_desc(ds + kk * 16 * kBoxRowBytes, kDsBytes, 1024);
    const uint64_t db = wgmma_desc(kc + kk * 16 * kBoxRowBytes, kKBox, 1024);
    if (kk == 0) {
      wgmma_ss_first<1, 1>(d, da, db);
    } else {
      wgmma_ss<1, 1>(d, da, db);
    }
  }
  wgmma_commit();
}

template <int DP>
__global__ void __launch_bounds__(kHThreads, 1) bwd_bf16_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tdk,
    const __grid_constant__ CUtensorMap tdv, const HParams p) {
  using L = HLayout<DP>;
  constexpr int NB = L::boxes;
  extern __shared__ uint8_t h_smem[];
  const uint32_t base = (smem_addr(h_smem) + 1023u) & ~1023u;
  const uint32_t sk = base + L::k_off, sv = base + L::v_off;
  const uint32_t sq = base + L::q_off, sdo = base + L::do_off;
  const uint32_t sds = base + L::ds_off, sdq = base + L::dq_off;
  const uint32_t sst = base + L::st_off;
  const uint32_t kv_full = base + L::bar_off, full = kv_full + 8;

  // blockIdx.x walks the key tiles from the last down (see the note at
  // the top); the steps: the query tiles at or below the diagonal, for each
  // query head of the group in turn
  const int j = p.nkt - 1 - static_cast<int>(blockIdx.x);
  const int k0 = j * kHBN;
  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv;
  const int first = p.causal ? 2 * j : 0;
  const int per_head = p.nqt - first;
  const int steps = p.group * per_head;
  const bool loader = threadIdx.x == 0, writer = threadIdx.x == 128;

  // step it's query head and tile, and its dq workspace tile
  auto head = [&](int it) { return hk * p.group + it / per_head; };
  auto qtile = [&](int it) { return first + it % per_head; };
  // step it's workspace tile, and this block's turn there: the key tiles
  // at or below the diagonal of query tile i add in turn from the highest
  auto ws_tile = [&](int it) {
    return static_cast<size_t>(b * p.H + head(it)) * p.nqt + qtile(it);
  };
  auto turn_of = [&](int it) {
    return (p.causal ? qtile(it) / 2 : p.nkt - 1) - j;
  };
  // q, do and the stats rows of step it into stage it % kHStages
  auto load_step = [&](int it) {
    const int s = it % kHStages, h = head(it), i = qtile(it);
    const uint32_t bar = full + 8 * s;
    mbar_expect_tx(bar, 2 * L::qt_bytes + kStatBytes);
    for (int c = 0; c < NB; ++c) {
      tma_load(sq + s * L::qt_bytes + c * kQBox, tq, bar, c * kBoxCols,
               i * kHBM, h, b);
      tma_load(sdo + s * L::qt_bytes + c * kQBox, tdo, bar, c * kBoxCols,
               i * kHBM, h, b);
    }
    bulk_load(sst + s * kStatBytes,
              p.stats + (static_cast<size_t>(b * p.H + h) * p.nqt + i) * 2 * kHBM,
              kStatBytes, bar);
  };

  if (loader) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kHStages; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(kv_full, 2 * L::kv_bytes);
    for (int c = 0; c < NB; ++c) {
      tma_load(sk + c * kKBox, tk, kv_full, c * kBoxCols, k0, hk, b);
      tma_load(sv + c * kKBox, tv, kv_full, c * kBoxCols, k0, hk, b);
    }
    for (int it = 0; it < kHStages && it < steps; ++it) load_step(it);
  }
  __syncthreads();

  // Warpgroup w: 64 keys, their dK and dV.
  const int w = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kr = 64 * w + 16 * warp + g;  // this thread's key rows: kr, kr + 8
  const int key_lo = k0 + kr, key_hi = key_lo + 8;
  const int kw0 = k0 + 64 * w;            // the warpgroup's first key
  const uint32_t sk_w = sk + 64 * w * kBoxRowBytes;
  const uint32_t sv_w = sv + 64 * w * kBoxRowBytes;
  // dQ = dS K: at D = 128 warpgroup w takes dQ's columns 64 w.. over all
  // 128 keys; at D <= 64 it takes all 64 columns over its own 64 keys, and
  // the two partial sums are added in shared memory
  constexpr bool kCols = DP > 64;
  const uint32_t kc = kCols ? sk + w * kKBox : sk_w;
  const int qr = 16 * warp + g;                // dQ's rows: qr, qr + 8
  const int col = (kCols ? 64 * w : 0) + 2 * t;  // and first column

  float dv[DP / 2], dk[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dv[i] = dk[i] = 0.f;
  float sc[32], dp[32], dq[32];  // S^T then P^T; dP^T then dS^T; dQ
  uint32_t pa[16], da[16];       // P^T and dS^T in bf16: A fragments

  mbar_wait(kv_full, 0);
  for (int it = 0; it < steps; ++it) {
    const int s = it % kHStages;
    const int q0 = qtile(it) * kHBM;
    const uint32_t qt = sq + s * L::qt_bytes, dot = sdo + s * L::qt_bytes;
    const uint32_t stt = sst + s * kStatBytes;
    const uint32_t ds = sds + (it & 1) * kDsBytes;
    mbar_wait(full + 8 * s, (it / kHStages) & 1);
    wgmma_fence();
    issue_rows<DP>(sc, sk_w, qt);
    issue_rows<DP>(dp, sv_w, dot);
    wgmma_wait<1>();
    keep(sc);

    // P^T = exp(S^T scale - lse), zero where masked: the mask is a branch
    // per step, taken only where the tile crosses the diagonal or S
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float4 st = ld_shared_v4(stt + (8 * jj + 2 * t) * 8);
      sc[4 * jj] = ex2(fmaf(sc[4 * jj], p.sl2, -st.x));
      sc[4 * jj + 1] = ex2(fmaf(sc[4 * jj + 1], p.sl2, -st.z));
      sc[4 * jj + 2] = ex2(fmaf(sc[4 * jj + 2], p.sl2, -st.x));
      sc[4 * jj + 3] = ex2(fmaf(sc[4 * jj + 3], p.sl2, -st.z));
    }
    if (kw0 + 64 > p.S || q0 + kHBM > p.S || (p.causal && kw0 + 63 > q0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = (i & 2) ? key_hi : key_lo;
        const int query = q0 + 8 * (i / 4) + 2 * t + (i & 1);
        if (key >= p.S || query >= p.S || (p.causal && key > query)) sc[i] = 0.f;
      }
    }
    wgmma_wait<0>();
    keep(dp);

    // dS^T = P^T (dP^T - delta); P^T and dS^T in bf16, the A fragments of
    // dV and dK (the accumulators' layout), and dS^T into shared memory for
    // dQ: rows = keys, 128-byte swizzled (the row's chunk index XORed with
    // g = row % 8)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float4 st = ld_shared_v4(stt + (8 * jj + 2 * t) * 8);
      const uint32_t lo = kr * kBoxRowBytes + ((jj ^ g) * 16) + 4 * t;
      const uint32_t hi = lo + 8 * kBoxRowBytes;
      pa[2 * jj] = pack_bf16(sc[4 * jj], sc[4 * jj + 1]);
      pa[2 * jj + 1] = pack_bf16(sc[4 * jj + 2], sc[4 * jj + 3]);
      da[2 * jj] = pack_bf16(sc[4 * jj] * (dp[4 * jj] - st.y),
                             sc[4 * jj + 1] * (dp[4 * jj + 1] - st.w));
      da[2 * jj + 1] = pack_bf16(sc[4 * jj + 2] * (dp[4 * jj + 2] - st.y),
                                 sc[4 * jj + 3] * (dp[4 * jj + 3] - st.w));
      st_shared(ds + lo, da[2 * jj]);
      st_shared(ds + hi, da[2 * jj + 1]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (writer) {
      // the last step's partial sums have left shared memory (their add
      // completes later)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
    named_sync(1, 256);  // dS^T of both warpgroups is in shared memory, and
                         // the dQ partial's buffer is free
    wgmma_fence();
    issue_acc(dv, pa, dot);
    issue_acc(dk, da, qt);
    issue_dq<kCols ? kHBN / 16 : 4>(dq, kCols ? ds : ds + 64 * w * kBoxRowBytes,
                                    kc);
    // the writer reads this step's turn counter under the products
    const int seen = writer ? ld_acquire(p.turns + ws_tile(it)) : 0;
    wgmma_wait<0>();
    keep(dv);
    keep(dk);
    keep(dq);
    keep(pa);
    keep(da);

    // the dQ partial to shared memory (dq_at's layout): rows qr, qr + 8,
    // columns col.. of each 8-column chunk k
    if (kCols || w == 1) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        st_shared_v2(sdq + dq_at<DP>(qr, col + 8 * k), dq[4 * k], dq[4 * k + 1]);
        st_shared_v2(sdq + dq_at<DP>(qr + 8, col + 8 * k), dq[4 * k + 2],
                     dq[4 * k + 3]);
      }
    }
    if (!kCols) {  // the first warpgroup adds its keys' sums to the second's
      named_sync(1, 256);
      if (w == 0) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const uint32_t lo = sdq + dq_at<DP>(qr, col + 8 * k);
          const uint32_t hi = sdq + dq_at<DP>(qr + 8, col + 8 * k);
          const float2 x = ld_shared_v2(lo), y = ld_shared_v2(hi);
          st_shared_v2(lo, x.x + dq[4 * k], x.y + dq[4 * k + 1]);
          st_shared_v2(hi, y.x + dq[4 * k + 2], y.y + dq[4 * k + 3]);
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(1, 256);  // the dQ partial is written; q, do, stats are free
    if (loader && it + kHStages < steps) load_step(it + kHStages);
    if (writer) {
      // the last step's add is complete: its turn passes to the next key
      // tile down. Then this step's partial into its workspace tile, in
      // turn: stored by the first contributor, added by the rest
      if (it > 0) {
        asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        st_release(p.turns + ws_tile(it - 1), turn_of(it - 1) + 1);
      }
      const int turn = turn_of(it);
      if (seen != turn) wait_turn(p.turns + ws_tile(it), turn);
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      float* dst = p.ws + ws_tile(it) * (kHBM * DP);
      if (turn == 0) {
        bulk_store(dst, sdq, L::dq_bytes);
      } else {
        bulk_reduce_add(dst, sdq, L::dq_bytes);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (writer && steps > 0) {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    st_release(p.turns + ws_tile(steps - 1), turn_of(steps - 1) + 1);
  }

  // dK (scaled) and dV in bf16 into the warpgroup's rows of the k and v
  // tiles (free: every product of both warpgroups is done), swizzled as the
  // dk and dv maps' boxes; then one thread stores them by TMA (rows past S,
  // columns past D are not written)
#pragma unroll
  for (int jj = 0; jj < DP / 8; ++jj) {
    const uint32_t at = (jj / 8) * kKBox + kr * kBoxRowBytes +
                        (((jj % 8) ^ g) * 16) + 4 * t;
    const uint32_t at8 = at + 8 * kBoxRowBytes;
    st_shared(sk + at, pack_bf16(dk[4 * jj] * p.scale, dk[4 * jj + 1] * p.scale));
    st_shared(sk + at8, pack_bf16(dk[4 * jj + 2] * p.scale, dk[4 * jj + 3] * p.scale));
    st_shared(sv + at, pack_bf16(dv[4 * jj], dv[4 * jj + 1]));
    st_shared(sv + at8, pack_bf16(dv[4 * jj + 2], dv[4 * jj + 3]));
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(2 + w, 128);
  if (threadIdx.x % 128 == 0) {
    for (int c = 0; c < NB; ++c) {
      tma_store(tdk, sk + c * kKBox + 64 * w * kBoxRowBytes, c * kBoxCols,
                kw0, hk, b);
      tma_store(tdv, sv + c * kKBox + 64 * w * kBoxRowBytes, c * kBoxCols,
                kw0, hk, b);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// dq = scale * the workspace's sums, in q's dtype and layout: a block per
// (b, h, query tile), a thread per 16-byte chunk of a row (dq_at's layout)
// at a time, its four columns written as four bf16.
template <int DP>
__global__ void __launch_bounds__(256) dq_convert_kernel(const BwdParams p,
                                                         const float* ws,
                                                         int nqt) {
  constexpr int kChunks = DP / 4;  // 16-byte chunks a row
  const int i = blockIdx.x, bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const float4* tile = reinterpret_cast<const float4*>(
      ws + (static_cast<size_t>(bh) * nqt + i) * (kHBM * DP));
  uint16_t* dq = static_cast<uint16_t*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int x = threadIdx.x; x < kHBM * kChunks; x += 256) {
    const int r = x / kChunks, c = 4 * ((x % kChunks) ^ (r & 7));
    const int row = i * kHBM + r;
    if (row >= p.S || c >= p.D) continue;
    const float4 v = tile[x];
    const uint2 out = make_uint2(pack_bf16(v.x * p.scale, v.y * p.scale),
                                 pack_bf16(v.z * p.scale, v.w * p.scale));
    *reinterpret_cast<uint2*>(dq + row * p.dq_ss + c) = out;
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

// Phases: 1 the preprocess, 2 the main kernel (dK/dV; and dQ's partial sums
// on the Hopper route), 4 dQ (its kernel, or the Hopper route's conversion).
template <int DP>
cudaError_t launch_f32(const BwdParams& p, int phases, cudaStream_t s) {
  constexpr size_t smem = f32_smem_bytes<DP>();
  const int n = (p.S + kF - 1) / kF;
  cudaError_t err = cudaSuccess;
  if (phases & 2) err = launch(dkdv_f32_kernel<DP>, dim3(n, p.B * p.Hkv), smem, s, p);
  if (err == cudaSuccess && (phases & 4)) {
    err = launch(dq_f32_kernel<DP>, dim3(n, p.B * p.H), smem, s, p);
  }
  return err;
}

cudaError_t launch_bf16_mma(const BwdParams& p, int phases, cudaStream_t s) {
  constexpr int DP = 256, DC = 128;
  cudaError_t err = cudaSuccess;
  if (phases & 2) {
    const dim3 kv_grid((p.S + kKBN - 1) / kKBN, p.B * p.Hkv, DP / DC);
    err = launch(dkdv_bf16_kernel<DP, DC>, kv_grid, dkdv_smem_bytes<DP>(), s, p);
  }
  if (err == cudaSuccess && (phases & 4)) {
    const dim3 q_grid((p.S + kQBM - 1) / kQBM, p.B * p.H, DP / DC);
    err = launch(dq_bf16_kernel<DP, DC>, q_grid, dq_smem_bytes<DP>(), s, p);
  }
  return err;
}

template <int DP>
int launch_bf16_wgmma(const BwdParams& p, float* stats, float* ws, int* turns,
                      int phases, cudaStream_t s) {
  using L = HLayout<DP>;
  const int nqt = (p.S + kHBM - 1) / kHBM, nkt = (p.S + kHBN - 1) / kHBN;
  if (phases & 1) {
    stats_kernel<<<dim3(nqt * kHBM / kStatRows, p.B * p.H), 32 * kStatRows / 2,
                   0, s>>>(p, reinterpret_cast<float2*>(stats), nqt * kHBM);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (phases & 2) {
    CUtensorMap tq, tk, tv, tdo, tdk, tdv;
    int err = encode_bf16_map(&tq, p.q, p.D, p.S, p.H, p.B, p.q_sb, p.q_sh,
                              p.q_ss, kHBM);
    if (err == 0) err = encode_bf16_map(&tk, p.k, p.D, p.S, p.Hkv, p.B, p.k_sb,
                                        p.k_sh, p.k_ss, kHBN);
    if (err == 0) err = encode_bf16_map(&tv, p.v, p.D, p.S, p.Hkv, p.B, p.v_sb,
                                        p.v_sh, p.v_ss, kHBN);
    if (err == 0) err = encode_bf16_map(&tdo, p.dout, p.D, p.S, p.H, p.B,
                                        p.do_sb, p.do_sh, p.do_ss, kHBM);
    if (err == 0) err = encode_bf16_map(&tdk, p.dk, p.D, p.S, p.Hkv, p.B,
                                        p.dk_sb, p.dk_sh, p.dk_ss, 64);
    if (err == 0) err = encode_bf16_map(&tdv, p.dv, p.D, p.S, p.Hkv, p.B,
                                        p.dv_sb, p.dv_sh, p.dv_ss, 64);
    if (err != 0) return err;
    const cudaError_t attr = cudaFuncSetAttribute(
        bwd_bf16_wgmma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    HParams hp;
    hp.S = p.S;
    hp.H = p.H;
    hp.Hkv = p.Hkv;
    hp.group = p.H / p.Hkv;
    hp.nqt = nqt;
    hp.nkt = nkt;
    hp.causal = p.causal;
    hp.scale = p.scale;
    hp.sl2 = p.scale * kLog2e;
    hp.stats = stats;
    hp.ws = ws;
    hp.turns = turns;
    bwd_bf16_wgmma_kernel<DP><<<dim3(nkt, p.B * p.Hkv), kHThreads, L::smem, s>>>(
        tq, tk, tv, tdo, tdk, tdv, hp);
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return static_cast<int>(launched);
  }
  if (phases & 4) {
    dq_convert_kernel<DP><<<dim3(nqt, p.B * p.H), 256, 0, s>>>(p, ws, nqt);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

// the caller gave less scratch than the route reads and writes
constexpr int kScratchError = 90000;

// Whether the caller's scratch (element counts of delta, dq_accum and
// turns) holds what the route reads and writes; the layout is documented
// at flash_attention_bwd_launch.
bool scratch_fits(const long long* len, int dtype, int B, int H, int S,
                  int D) {
  const long long bh = static_cast<long long>(B) * H;
  if (dtype != 1 || D > 128) return len[0] >= bh * S;
  const long long rows = bh * ((S + kHBM - 1) / kHBM) * kHBM;
  return len[0] >= rows * 2 && len[1] >= rows * (D <= 64 ? 64 : 128) &&
         len[2] >= rows / kHBM;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, do, dq, dk, dv alike).
// strides holds the (batch, head, sequence) strides in elements of q, k, v,
// o, do, dq, dk and dv, in that order; each last dim is dense. lse is the
// forward's (B, H, S) f32 log-sum-exp. The caller's scratch: on the bf16
// D <= 128 route, delta is (B, H, nqt * 64, 2) f32 (nqt = ceil(S / 64)),
// dq_accum (B, H, nqt, 64, 64 or 128 for D <= 64 or above) f32 and turns
// (B, H, nqt) int32, zero; elsewhere delta is (B, H, S) f32 and dq_accum and
// turns are not read. scratch_len holds the element counts of delta,
// dq_accum and turns as allocated (0 for one not given); a count below the
// route's returns kScratchError and launches nothing. phases: 1 the preprocess, 2 the main kernel, 4 dQ's
// kernel or conversion; 7 runs the whole backward, and the others time its
// kernels apart (phase 2 needs the turns zeroed again before each run). The
// caller guarantees 1 <= S, H % Hkv == 0, B * H <= 65535, D % 8 == 0 with
// 8 <= D <= 256, and (for bf16) 16-byte aligned rows and strides below
// 2^40 bytes (the tensor maps' limits).
int flash_attention_bwd_launch(int dtype, const void* q, const void* k,
                               const void* v, const void* o, const void* dout,
                               void* dq, void* dk, void* dv, const float* lse,
                               float* delta, float* dq_accum, int* turns,
                               const long long* strides,
                               const long long* scratch_len, int B, int H,
                               int Hkv, int S, int D, float scale, int causal,
                               int phases, void* stream) {
  if ((dtype != 0 && dtype != 1) || D < 8 || D > 256 || D % 8 != 0 || S < 1 ||
      Hkv < 1 || H % Hkv != 0 || B * H > 65535 || phases < 0 || phases > 7) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!scratch_fits(scratch_len, dtype, B, H, S, D)) return kScratchError;
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
  if (dtype == 1 && D <= 128) {  // bf16: the kernels are chosen by D alone
    return D <= 64 ? launch_bf16_wgmma<64>(p, delta, dq_accum, turns, phases, s)
                   : launch_bf16_wgmma<128>(p, delta, dq_accum, turns, phases, s);
  }
  cudaError_t err = cudaSuccess;
  if (phases & 1) {
    const dim3 rows((S + kThreads / 32 - 1) / (kThreads / 32), B * H);
    err = dtype == 1 ? launch(delta_kernel<uint16_t>, rows, 0, s, p)
                     : launch(delta_kernel<float>, rows, 0, s, p);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dtype == 1) {
    err = launch_bf16_mma(p, phases, s);
  } else if (D <= 32) {
    err = launch_f32<32>(p, phases, s);
  } else if (D <= 64) {
    err = launch_f32<64>(p, phases, s);
  } else if (D <= 128) {
    err = launch_f32<128>(p, phases, s);
  } else {
    err = launch_f32<256>(p, phases, s);
  }
  return static_cast<int>(err);
}

const char* flash_attention_bwd_error_string(int code) {
  static char buf[96];
  if (code == kScratchError) {
    return "the scratch given is smaller than the route reads and writes";
  }
  if (code >= kEncodeError) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed (CUresult %d)",
             code - kEncodeError);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
