// Flash attention (causal or not, grouped-query) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel, launched by flash_attention_bhsd). For q (B, H, S, D),
// k (B, Hkv, S, D) and v (B, Hkv, S, Dv), Dv <= D, H a multiple of Hkv,
// query head h reading kv head h / (H / Hkv), it computes
//
//     o[b, h, i] = sum_j softmax_j(scale * <q[b, h, i], k[b, hk, j]>) v[b, hk, j]
//
// (o of width Dv) over j <= i when causal, with an online softmax: a
// running row max m and row sum l and the output accumulator, all f32, are
// carried over kv tiles, so the (S, S) scores never reach device memory. Masked scores are -1e30
// as in the TPU kernel, the probabilities are rounded to bf16 for the
// second product, and the output is acc / max(l, 1e-30) in q's dtype.
//
// Bound. At the serving path's prefill shape (B=4, S=4096, H=56, Hkv=8,
// D=128, bf16, causal) the two products take 4*B*H*D*S(S+1)/2 = 962 GFLOP,
// 0.97 ms at the H100's 989 TFLOP/s for bf16 tensor cores, while q, k, v and
// o are 0.54 GB, 0.16 ms at 3.35 TB/s: the kernel is bound by operations.
// At MLA's prefill (deepseek-v3: B=4, S=4096, H=Hkv=128, D=192, Dv=128) the
// products take 2*B*H*(D+Dv)*S(S+1)/2 = 2,750 GFLOP, 2.78 ms.
//
// Three kernels; the entry point picks one by (dtype, D, Dv) alone, an
// explicit choice by shape (no error is caught and retried another way):
//   * bf16, Dv <= 128 (every config of the zoo: D = Dv = 128, or MLA's
//     D = 192, Dv = 128): the Hopper kernel, flash_bf16_wgmma_kernel<DQK,
//     DV>, at <64, 64> for D <= 64, <128, 128> for D <= 128, <192, 128> for
//     D <= 192 and <256, 128> for D <= 256. What its design does about the
//     bound:
//       - wgmma, the only path to the full tensor-core rate, for both
//         products: S = q k^T with both operands in shared memory, and
//         O += P v with P taken from registers (the f32 scores, rounded to
//         bf16 pairs, already lie as wgmma's A fragment) and v read as a
//         transposed (MN-major) operand;
//       - 128 query rows per block, two consumer warpgroups of 64, so each
//         k/v tile (96 keys) is staged once for 128 rows;
//       - TMA loads through tensor maps built on the host from the (b, h, s)
//         strides: no thread spends registers or instructions on copies,
//         the model-layout (B, S, H, D) views go in as they are, and rows
//         past S or columns past D (q, k) or Dv (v) come back as zeros (the
//         head dims round up to their bucket, S needs no padding);
//       - a ring of k/v stages with full and empty mbarriers, kept full by
//         one producer thread, so loads run under the products; setmaxnreg
//         moves registers from the producer warpgroup to the consumers;
//       - the softmax is scheduled under the tensor cores two ways: the two
//         consumer warpgroups take turns (named barriers) to issue their
//         products, so one's softmax runs under the other's products, and
//         within a warpgroup the softmax of tile j runs under P v of tile
//         j - 1 (issued with the scores of tile j). That keeps the scores
//         of one tile, P of the previous one and the output in registers
//         at once, which is why a tile has 96 keys and not 128: at 128,
//         ptxas spills them and then serialises every wgmma;
//       - the mask is one branch per tile, taken only by tiles that cross
//         the diagonal or S, so the softmax of every other tile is
//         straight-line code;
//       - causal: tiles wholly above the diagonal are skipped, only the one
//         or two tiles that cross it (or S) are masked, the last tile comes
//         first, and a kv head's blocks are issued longest first;
//       - the blocks of one kv head (its query tiles and group) run
//         together, so its k and v are read from device memory about once
//         and then from L2, whatever the group (MLA's is 1);
//       - the output is staged in shared memory and stored by TMA.
//     Two head dims (MLA): q and k tiles are DQK columns wide, v and o
//     tiles DV. The consumer's registers hold o (DV/2 a thread), the scores
//     of one tile (48) and P of the previous one (24), which depend on DV
//     and the tile alone, so <192, 128> and <256, 128> keep the 64 + 48 +
//     24 of <128, 128>, and a tile stays 96 keys for the reason above; only
//     q k^T takes more k-steps (DQK / 16: 12 at 192 against 8 at 128) for
//     the same softmax work a tile. What grows is shared memory: q 128 x
//     DQK, two k tiles 96 x DQK and two v tiles 96 x DV in bf16, with the
//     barriers and the alignment 169 KB at <192, 128> and 209 KB at
//     <256, 128>, both within the 227 KB a block can take (WsLayout).
//     Nothing is padded in device memory: MLA's v is read at its own 128
//     columns and o written at them.
//   * bf16, Dv > 128 (no config reaches it): mma.sync m16n8k16 with
//     cp.async double buffering, 64 query rows per block.
//   * f32: a CUDA-core kernel (f32 FMA, exact f32 products as the TPU
//     kernel's) that is right, not fast; no full-size path runs it.
//
// Ragged shapes: any S >= 1, any D and Dv <= D that are multiples of 8 up
// to 256.
// One block owns each output row and no atomics are used, so two runs on
// the same inputs give bit-identical results. The C entry point launches on
// the caller's stream, allocates nothing, and returns a nonzero code when a
// tensor map cannot be encoded or the launch fails.
//
// For training, each kernel also writes the per-row log-sum-exp of the
// scaled scores, lse = m + log(l) (natural log, f32, (B, H, S) contiguous),
// from the m and l its epilogue already holds, when the caller passes a
// buffer for it; the backward (csrc/flash_attention_bwd.cu) recomputes the
// probabilities from it. Serving passes none, and nothing more is written.

#include <stdio.h>

#include "hopper.cuh"

namespace {

constexpr float kMasked = -1e30f;  // the TPU kernel's mask value
constexpr int kThreads = 128;      // four warps (the f32 kernel)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, S) or null
  long long q_sb, q_sh, q_ss;  // strides in elements; the last dim is dense
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int B, H, Hkv, S, D, Dv;  // D: q and k; Dv: v and o
  float scale;
  int causal;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// f32: CUDA cores. Block = 32 query rows (8 per warp), kv tiles of 32 rows.
// Lane j scores key j of the tile against the warp's 8 rows; for the second
// product lane c owns output columns c, c+32, ... of those rows.
// ---------------------------------------------------------------------------

constexpr int kF32BM = 32, kF32BN = 32, kF32Rows = kF32BM / 4;

template <int DP>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (kF32BM * DP + kF32BN * (DP + 1) + kF32BN * DP);
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(const Params p) {
  constexpr int BM = kF32BM, BN = kF32BN, R = kF32Rows, NI = DP / 32;
  extern __shared__ float smem[];
  float* qs = smem;                  // BM x DP, q * scale
  float* ks = qs + BM * DP;          // BN x (DP + 1): padded, lanes read rows
  float* vs = ks + BN * (DP + 1);    // BN x DP

  const int nq = (p.S + BM - 1) / BM;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BM;  // longest first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = threadIdx.x; i < BM * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    qs[i] = (q0 + r < p.S && c < p.D) ? q[(q0 + r) * p.q_ss + c] * p.scale : 0.f;
  }

  float m[R], l[R], acc[R][NI];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NI; ++i) acc[r][i] = 0.f;
  }

  const int row0 = q0 + warp * R;
  const int kv_end = p.causal ? min(p.S, q0 + BM) : p.S;
  for (int n0 = 0; n0 < kv_end; n0 += BN) {
    __syncthreads();  // the previous tile is consumed (and qs is staged)
    for (int i = threadIdx.x; i < BN * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      const bool in = n0 + r < p.S;
      ks[r * (DP + 1) + c] = in && c < p.D ? k[(n0 + r) * p.k_ss + c] : 0.f;
      vs[r * DP + c] = in && c < p.Dv ? v[(n0 + r) * p.v_ss + c] : 0.f;
    }
    __syncthreads();

    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    for (int c = 0; c < DP; ++c) {
      const float kc = ks[lane * (DP + 1) + c];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = fmaf(qs[(warp * R + r) * DP + c], kc, s[r]);
    }
    const int j = n0 + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool valid = j < p.S && (!p.causal || j <= row0 + r);
      const float sr = valid ? s[r] : kMasked;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float alpha = expf(m[r] - m_new);
      s[r] = expf(sr - m_new);
      l[r] = alpha * l[r] + warp_sum(s[r]);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < NI; ++i) acc[r][i] *= alpha;
    }
    for (int jj = 0; jj < BN; ++jj) {
      float vv[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) vv[i] = vs[jj * DP + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pj = __shfl_sync(0xffffffffu, s[r], jj);
#pragma unroll
        for (int i = 0; i < NI; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
      }
    }
  }

  if (p.lse != nullptr && lane == 0) {  // q was scaled: m is natural
    float* lse = p.lse + static_cast<size_t>(blockIdx.y) * p.S;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (row0 + r < p.S) lse[row0 + r] = m[r] + logf(l[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (row0 + r >= p.S) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int c = lane + 32 * i;
      if (c < p.Dv) o[(row0 + r) * p.o_ss + c] = acc[r][i] / den;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, Dv > 128: tensor cores through mma.sync m16n8k16 (bf16 x bf16 ->
// f32), the Ampere path; no config of the zoo reaches it.
// Fragment layout (PTX ISA, per lane: g = lane / 4, t = lane % 4):
//   A 16x16 row-major: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                      a3 (g+8, 2t+8..)
//   B 16x8 "col":      b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C 16x8 f32:        c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
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

constexpr int kBf16Warps = 4;  // 16 query rows each

template <int DP>
struct Bf16Tiles {
  static constexpr int BM = 16 * kBf16Warps;
  static constexpr int BN = 32;  // keys per tile (the kernel runs D = 256)
  static constexpr int LD = DP + 8;  // padded shared row, in bf16
  // k and v tiles, two of each: one in use, one arriving
  static constexpr size_t smem = 2 * 2 * BN * LD * sizeof(uint16_t);
};

template <int DP>
__global__ void __launch_bounds__(32 * kBf16Warps)
    flash_bf16_kernel(const Params p) {
  using T = Bf16Tiles<DP>;
  constexpr int BM = T::BM, BN = T::BN, LD = T::LD;
  constexpr int NTH = 32 * kBf16Warps;
  constexpr int KC = DP / 16;             // k-steps of q k^T
  constexpr int NT = BN / 8;              // 8-column tiles of the scores
  constexpr int DT = DP / 8;              // 8-column tiles of the output
  constexpr int VPR = DP / 8;             // 16-byte vectors per row
  extern __shared__ __align__(16) uint16_t kv_smem[];

  const int nq = (p.S + BM - 1) / BM;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BM;  // longest first
  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
  const uint16_t* q = static_cast<const uint16_t*>(p.q) + b * p.q_sb + h * p.q_sh;
  const uint16_t* k = static_cast<const uint16_t*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const uint16_t* v = static_cast<const uint16_t*>(p.v) + b * p.v_sb + hk * p.v_sh;
  uint16_t* o = static_cast<uint16_t*>(p.o) + b * p.o_sb + h * p.o_sh;

  // Stage the k and v rows [n0, n0 + BN) into buffer buf, zeros past S, D
  // (k) or Dv (v).
  auto load_tile = [&](int n0, int buf) {
    uint16_t* kd = kv_smem + buf * 2 * BN * LD;
    uint16_t* vd = kd + BN * LD;
    for (int i = threadIdx.x; i < BN * VPR; i += NTH) {
      const int r = i / VPR, c = (i % VPR) * 8;
      const bool ik = n0 + r < p.S && c < p.D, iv = n0 + r < p.S && c < p.Dv;
      cp_async16(kd + r * LD + c, ik ? k + (n0 + r) * p.k_ss + c : k, ik);
      cp_async16(vd + r * LD + c, iv ? v + (n0 + r) * p.v_ss + c : v, iv);
    }
    cp_async_commit();
  };

  const int kv_end = p.causal ? min(p.S, q0 + BM) : p.S;
  const int n_tiles = (kv_end + BN - 1) / BN;
  load_tile(0, 0);

  // This warp's 16 query rows as A fragments, straight from device memory.
  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (e & 1) ? r_hi : r_lo;
      const int c = kc * 16 + 2 * t + ((e & 2) ? 8 : 0);
      qa[kc][e] = (r < p.S && c < p.D)
                      ? *reinterpret_cast<const uint32_t*>(q + r * p.q_ss + c)
                      : 0u;
    }
  }

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m_lo = kMasked, m_hi = kMasked, l_lo = 0.f, l_hi = 0.f;  // log2 domain
  const float sl2 = p.scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    const int n0 = it * BN;
    if (it + 1 < n_tiles) {  // the next tile flies in while this one is used
      load_tile(n0 + BN, (it + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint16_t* kb = kv_smem + (it & 1) * 2 * BN * LD;
    const uint16_t* vb = kb + BN * LD;

    // scores = q k^T for 16 rows x BN keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t kf[4];  // b0, b1 of key tiles n and n + 1
        ldmatrix_x4(kf, kb + ((n + (mi >> 1)) * 8 + mr) * LD + kc * 16 +
                            (mi & 1) * 8);
        mma_bf16(s[n], qa[kc], kf[0], kf[1]);
        mma_bf16(s[n + 1], qa[kc], kf[2], kf[3]);
      }
    }

    // scale into the log2 domain, mask, and the online softmax update
    const bool edge = n0 + BN > p.S || (p.causal && n0 + BN > q0 + warp * 16);
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (edge) {
          const int j = n0 + n * 8 + 2 * t + (e & 1);
          const int r = (e & 2) ? r_hi : r_lo;
          if (j >= p.S || (p.causal && j > r)) x = kMasked;
        }
        s[n][e] = x;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {  // the 4 lanes that share a row
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, o2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, o2));
    }
    const float a_lo = exp2f(m_lo - mx_lo), a_hi = exp2f(m_hi - mx_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = exp2f(s[n][0] - m_lo);
      s[n][1] = exp2f(s[n][1] - m_lo);
      s[n][2] = exp2f(s[n][2] - m_hi);
      s[n][3] = exp2f(s[n][3] - m_hi);
      sum_lo += s[n][0] + s[n][1];
      sum_hi += s[n][2] + s[n][3];
    }
    l_lo = l_lo * a_lo + sum_lo;  // this lane's share; lanes are added at the end
    l_hi = l_hi * a_hi + sum_hi;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      acc[d][0] *= a_lo;
      acc[d][1] *= a_lo;
      acc[d][2] *= a_hi;
      acc[d][3] *= a_hi;
    }

    // acc += p v: the score fragments of two 8-key tiles are the A fragment
    // of one 16-key step; v's B fragments come transposed from ldmatrix
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        uint32_t vf[4];  // b0, b1 of output tiles d and d + 1
        ldmatrix_x4_trans(vf, vb + (kc * 16 + (mi & 1) * 8 + mr) * LD +
                                  (d + (mi >> 1)) * 8);
        mma_bf16(acc[d], pa, vf[0], vf[1]);
        mma_bf16(acc[d + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this buffer is free for the tile after next
  }

#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, o2);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, o2);
  }
  if (p.lse != nullptr && t == 0) {  // m and l are in the log2 domain
    float* lse = p.lse + static_cast<size_t>(blockIdx.y) * p.S;
    if (r_lo < p.S) lse[r_lo] = (m_lo + log2f(l_lo)) * kLn2;
    if (r_hi < p.S) lse[r_hi] = (m_hi + log2f(l_hi)) * kLn2;
  }
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int c = d * 8 + 2 * t;
    if (c >= p.Dv) continue;
    if (r_lo < p.S) {
      *reinterpret_cast<uint32_t*>(o + r_lo * p.o_ss + c) =
          pack_bf16(acc[d][0] * inv_lo, acc[d][1] * inv_lo);
    }
    if (r_hi < p.S) {
      *reinterpret_cast<uint32_t*>(o + r_hi * p.o_ss + c) =
          pack_bf16(acc[d][2] * inv_hi, acc[d][3] * inv_hi);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, Dv <= 128: TMA, an mbarrier ring, warp specialisation and wgmma.
//
// A block owns 128 query rows of one (b, h): 384 threads, warpgroup 0 the
// producer (one thread issues every TMA load), warpgroups 1 and 2 the
// consumers, 64 rows each. Shared memory holds q (DQK columns), kStages k
// tiles (DQK) and kStages v tiles (DV) of 96 keys, each tile 128-byte
// swizzled as TMA writes it
// and wgmma reads it (hopper.cuh gives the layout and the wgmma fragments:
// the scores' accumulator, packed pairwise into bf16x2, is P's A fragment).
// ---------------------------------------------------------------------------

constexpr int kWsBM = 128;       // query rows per block, 64 per consumer
constexpr int kWsBN = 96;        // keys per k/v tile
constexpr int kWsStages = 2;     // depth of the k/v ring
constexpr int kWsThreads = 384;  // producer warpgroup + two consumers

template <int DQK, int DV>
struct WsLayout {
  static_assert(DQK % kBoxCols == 0 && DV % kBoxCols == 0 && DV <= DQK &&
                DV <= 128, "whole boxes; o is staged in q's rows; o[DV/2]");
  static constexpr int qk_boxes = DQK / kBoxCols;  // of q and of a k tile
  static constexpr int v_boxes = DV / kBoxCols;    // of a v tile and of o
  static constexpr uint32_t q_bytes = kWsBM * DQK * 2;
  static constexpr uint32_t k_bytes = kWsBN * DQK * 2;  // one k tile
  static constexpr uint32_t v_bytes = kWsBN * DV * 2;   // one v tile
  static constexpr uint32_t k_off = q_bytes;
  static constexpr uint32_t v_off = k_off + kWsStages * k_bytes;
  static constexpr uint32_t bar_off = v_off + kWsStages * v_bytes;
  // q full; per stage: k full, v full, k empty, v empty
  static constexpr int n_bars = 1 + 4 * kWsStages;
  static constexpr size_t smem = bar_off + 8 * n_bars + 1024;  // + alignment
  // 173,128 bytes at <192, 128>, 214,088 at <256, 128>: both fit
  static_assert(smem <= 232448, "a block takes at most 227 KB");
};

struct WsParams {
  int S, H, Hkv, group, nq, causal;
  float sl2;  // scale * log2(e): scores go to the log2 domain
  float* lse;  // (B, H, S) or null
};

// The two consumer warpgroups take turns on the tensor cores: a warpgroup
// issues its products only in its turn and hands the turn over once they
// are issued, so one warpgroup's softmax runs under the other's products.
// Named barrier 3 + w holds warpgroup w's turn; warpgroup 0 goes first, and
// warpgroup 1 keeps its last hand-over so every barrier's arrivals match.
struct Turns {
  int mine, other;
  __device__ explicit Turns(int w) : mine(3 + w), other(4 - w) {
    if (w == 1) named_arrive(3, 256);
  }
  __device__ void begin() const { named_sync(mine, 256); }
  __device__ void end(bool last) const {
    if (!(last && mine == 4)) named_arrive(other, 256);
  }
};

// The online softmax of this thread's two rows (r_lo and r_hi, whose four
// lanes share a row's max through shuffles), in the log2 domain.
struct RowStats {
  float m_lo = kMasked, m_hi = kMasked, l_lo = 0.f, l_hi = 0.f;

  // Scores of the tile at keys n0.. into probabilities, in place: scale,
  // the mask on a tile that crosses the diagonal or S, the new running max
  // and sum; a_lo, a_hi rescale the output accumulator.
  template <int N>
  __device__ __forceinline__ void update(float (&sc)[N], int n0, int t,
                                         int r_lo, int r_hi, int row0,
                                         const WsParams& p, float& a_lo,
                                         float& a_hi) {
    const bool edge = n0 + 2 * N > p.S || (p.causal && n0 + 2 * N - 1 > row0);
#pragma unroll
    for (int i = 0; i < N; ++i) sc[i] *= p.sl2;
    if (edge) {  // a branch per tile: the common path stays straight-line
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int key = n0 + 8 * (i / 4) + 2 * t + (i & 1);
        const int r = (i & 2) ? r_hi : r_lo;
        if (key >= p.S || (p.causal && key > r)) sc[i] = kMasked;
      }
    }
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, x));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, x));
    }
    a_lo = ex2(m_lo - mx_lo);
    a_hi = ex2(m_hi - mx_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      sc[4 * j] = ex2(sc[4 * j] - m_lo);
      sc[4 * j + 1] = ex2(sc[4 * j + 1] - m_lo);
      sc[4 * j + 2] = ex2(sc[4 * j + 2] - m_hi);
      sc[4 * j + 3] = ex2(sc[4 * j + 3] - m_hi);
      sum_lo += sc[4 * j] + sc[4 * j + 1];
      sum_hi += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l_lo = l_lo * a_lo + sum_lo;  // this lane's share; lanes add at the end
    l_hi = l_hi * a_hi + sum_hi;
  }
};

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float a_lo, float a_hi) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= a_lo;
    o[4 * j + 1] *= a_lo;
    o[4 * j + 2] *= a_hi;
    o[4 * j + 3] *= a_hi;
  }
}

// D (64 x 96, f32) (+)= A (64 x 16, shared) B (16 x 96, shared, K-major).
__device__ __forceinline__ void wgmma_ss(float (&d)[48], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(accumulate));
}

// S = q k^T of one tile into sc (64 rows of q at sq_w, kWsBN keys at kt),
// DQK/16 steps of k16: within a 64-column box a step advances 32 bytes, past
// it a box. Issued and committed as one group.
template <int DQK>
__device__ __forceinline__ void issue_qk(float (&sc)[kWsBN / 2], uint32_t sq_w,
                                         uint32_t kt) {
#pragma unroll
  for (int kk = 0; kk < DQK / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss(sc, wgmma_desc(sq_w + (kk / 4) * kWsBM * kBoxRowBytes + col,
                                 16, 1024),
                  wgmma_desc(kt + (kk / 4) * kWsBN * kBoxRowBytes + col, 16,
                             1024),
                  kk > 0);
  }
  wgmma_commit();
}

// O += P v of one tile, P's A fragments in pa: v at vt (keys x DV, DV
// contiguous) is the transposed B operand, 8 key rows 128 bytes apart, the
// next 8 at 1024 bytes, the next 64 columns one box (kWsBN keys) further.
template <int N>
__device__ __forceinline__ void issue_pv(float (&o)[N],
                                         const uint32_t (&pa)[kWsBN / 4],
                                         uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < kWsBN / 16; ++kk) {
    wgmma_rs(o, pa + 4 * kk,
             wgmma_desc(vt + kk * 16 * kBoxRowBytes, kWsBN * kBoxRowBytes,
                        1024));
  }
  wgmma_commit();
}

// Probabilities to P's A fragments: register i holds (sc[2i], sc[2i+1]).
__device__ __forceinline__ void to_bf16(uint32_t (&pa)[kWsBN / 4],
                                        const float (&sc)[kWsBN / 2]) {
#pragma unroll
  for (int i = 0; i < kWsBN / 4; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kWsThreads, 1) flash_bf16_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap to, const WsParams p) {
  using L = WsLayout<DQK, DV>;
  constexpr int NBQK = L::qk_boxes, NBV = L::v_boxes;
  constexpr uint32_t kQBox = kWsBM * kBoxRowBytes;   // one box of q
  constexpr uint32_t kKVBox = kWsBN * kBoxRowBytes;  // one box of a k/v tile
  extern __shared__ uint8_t ws_smem[];
  const uint32_t sq = (smem_addr(ws_smem) + 1023u) & ~1023u;
  const uint32_t sk = sq + L::k_off, sv = sq + L::v_off;
  const uint32_t bars = sq + L::bar_off;
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8, v_full = k_full + 8 * kWsStages;
  const uint32_t k_empty = v_full + 8 * kWsStages;
  const uint32_t v_empty = k_empty + 8 * kWsStages;

  // Blocks walk the (b, kv head) pairs slowest; within one, the query
  // tiles from the last (longest causal) down, and within a tile the
  // query heads of the kv head's group. The blocks in flight then read
  // the k and v of one or two kv heads, which stay in L2. ((b, h) fastest
  // would put one query tile of 132 heads in flight: with H = Hkv (MLA)
  // they share no k or v, and the loads, not the products, bound it.)
  const int per_kv = p.nq * p.group;
  const int bk = blockIdx.x / per_kv, rest = blockIdx.x % per_kv;
  const int b = bk / p.Hkv, hk = bk % p.Hkv, h = hk * p.group + rest % p.group;
  const int q0 = (p.nq - 1 - rest / p.group) * kWsBM;
  const int bh = b * p.H + h;
  const int kv_end = p.causal ? min(p.S, q0 + kWsBM) : p.S;
  const int n_tiles = (kv_end + kWsBN - 1) / kWsBN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kWsStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 8);  // one arrival per consumer warp
      mbar_init(v_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // The producer: q once, then k/v tiles from the last one down, each
    // into the next stage of the ring as soon as the consumers free it.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::q_bytes);
      for (int c = 0; c < NBQK; ++c) {
        tma_load(sq + c * kQBox, tq, q_full, c * kBoxCols, q0, h, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kWsStages;
        const uint32_t freed = ((it / kWsStages) & 1) ^ 1;
        const int n0 = (n_tiles - 1 - it) * kWsBN;
        if (it >= kWsStages) mbar_wait(k_empty + 8 * s, freed);
        mbar_expect_tx(k_full + 8 * s, L::k_bytes);
        for (int c = 0; c < NBQK; ++c) {
          tma_load(sk + s * L::k_bytes + c * kKVBox, tk, k_full + 8 * s,
                   c * kBoxCols, n0, hk, b);
        }
        if (it >= kWsStages) mbar_wait(v_empty + 8 * s, freed);
        mbar_expect_tx(v_full + 8 * s, L::v_bytes);
        for (int c = 0; c < NBV; ++c) {
          tma_load(sv + s * L::v_bytes + c * kKVBox, tv, v_full + 8 * s,
                   c * kBoxCols, n0, hk, b);
        }
      }
    }
    return;
  }

  // A consumer warpgroup: 64 query rows, their f32 statistics and output.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int w = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int row0 = q0 + 64 * w;
  const int r_lo = row0 + 16 * warp + lane / 4, r_hi = r_lo + 8;
  const uint32_t sq_w = sq + w * 64 * kBoxRowBytes;  // this warpgroup's q rows
  const Turns turns(w);

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  RowStats st;
  float sc[kWsBN / 2];      // scores, then probabilities, of one tile
  uint32_t pa[kWsBN / 4];   // those probabilities in bf16: P's A fragments

  auto full = [&](uint32_t bar, int it) {
    mbar_wait(bar + 8 * (it % kWsStages), (it / kWsStages) & 1);
  };
  auto release = [&](uint32_t bar, int it) {
    if (lane == 0) mbar_arrive(bar + 8 * (it % kWsStages));
  };
  auto n0_of = [&](int it) { return (n_tiles - 1 - it) * kWsBN; };
  auto k_tile = [&](int it) { return sk + (it % kWsStages) * L::k_bytes; };
  auto v_tile = [&](int it) { return sv + (it % kWsStages) * L::v_bytes; };

  // Tile 0 (the last in key order): its scores and softmax. Then for each
  // next tile, in one turn: the scores of tile it, the output rescaled by
  // the last softmax step, and P v of tile it - 1; the softmax of tile it
  // runs under P v. Last, P v of the last tile.
  float a_lo, a_hi;
  mbar_wait(q_full, 0);
  full(k_full, 0);
  turns.begin();
  wgmma_fence();
  issue_qk<DQK>(sc, sq_w, k_tile(0));
  turns.end(false);
  wgmma_wait<0>();
  keep(sc);
  release(k_empty, 0);
  st.update(sc, n0_of(0), t, r_lo, r_hi, row0, p, a_lo, a_hi);
  to_bf16(pa, sc);
  for (int it = 1; it < n_tiles; ++it) {
    full(k_full, it);
    full(v_full, it - 1);
    turns.begin();
    wgmma_fence();
    issue_qk<DQK>(sc, sq_w, k_tile(it));
    rescale(o, a_lo, a_hi);
    wgmma_fence();
    issue_pv(o, pa, v_tile(it - 1));
    turns.end(false);
    wgmma_wait<1>();
    keep(sc);
    release(k_empty, it);
    st.update(sc, n0_of(it), t, r_lo, r_hi, row0, p, a_lo, a_hi);
    wgmma_wait<0>();
    keep(o);
    keep(pa);
    release(v_empty, it - 1);
    to_bf16(pa, sc);
  }
  full(v_full, n_tiles - 1);
  turns.begin();
  rescale(o, a_lo, a_hi);
  wgmma_fence();
  issue_pv(o, pa, v_tile(n_tiles - 1));
  turns.end(true);
  wgmma_wait<0>();
  keep(o);
  keep(pa);
  release(v_empty, n_tiles - 1);

  // o / l into this warpgroup's q rows (free now; DQK >= DV columns),
  // swizzled as the o map's boxes, then one thread stores them by TMA (rows
  // past S, columns past Dv are not written)
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    st.l_lo += __shfl_xor_sync(0xffffffffu, st.l_lo, x);
    st.l_hi += __shfl_xor_sync(0xffffffffu, st.l_hi, x);
  }
  if (p.lse != nullptr && t == 0) {  // the rows' final m and l (log2)
    float* lse = p.lse + static_cast<size_t>(bh) * p.S;
    if (r_lo < p.S) lse[r_lo] = (st.m_lo + log2f(st.l_lo)) * kLn2;
    if (r_hi < p.S) lse[r_hi] = (st.m_hi + log2f(st.l_hi)) * kLn2;
  }
  const float inv_lo = 1.f / fmaxf(st.l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(st.l_hi, 1e-30f);
  const int rl = 16 * warp + lane / 4, rh = rl + 8;  // rows within the 64
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
    const uint32_t box = sq_w + (j / 8) * kQBox;
    const uint32_t byte = 4 * t;  // within the 16-byte chunk j % 8
    st_shared(box + rl * kBoxRowBytes + (((j % 8) ^ (rl % 8)) * 16) + byte,
              pack_bf16(o[4 * j] * inv_lo, o[4 * j + 1] * inv_lo));
    st_shared(box + rh * kBoxRowBytes + (((j % 8) ^ (rh % 8)) * 16) + byte,
              pack_bf16(o[4 * j + 2] * inv_hi, o[4 * j + 3] * inv_hi));
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(1 + w, 128);
  if (threadIdx.x % 128 == 0) {
    for (int c = 0; c < NBV; ++c) {
      tma_store(to, sq_w + c * kQBox, c * kBoxCols, row0, h, b);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <int DP>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + kF32BM - 1) / kF32BM, p.B * p.H);
  flash_f32_kernel<DP><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_bf16_mma(const Params& p, cudaStream_t stream) {
  constexpr int DP = 256;
  using T = Bf16Tiles<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + T::BM - 1) / T::BM, p.B * p.H);
  flash_bf16_kernel<DP><<<grid, 32 * kBf16Warps, T::smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DQK, int DV>
int launch_bf16_wgmma(const Params& p, cudaStream_t stream) {
  using L = WsLayout<DQK, DV>;
  const int nq = (p.S + kWsBM - 1) / kWsBM;
  const long long blocks = static_cast<long long>(p.B) * p.H * nq;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, to;
  int err = encode_bf16_map(&tq, p.q, p.D, p.S, p.H, p.B, p.q_sb, p.q_sh,
                            p.q_ss, kWsBM);
  if (err == 0) err = encode_bf16_map(&tk, p.k, p.D, p.S, p.Hkv, p.B, p.k_sb,
                                      p.k_sh, p.k_ss, kWsBN);
  if (err == 0) err = encode_bf16_map(&tv, p.v, p.Dv, p.S, p.Hkv, p.B, p.v_sb,
                                      p.v_sh, p.v_ss, kWsBN);
  if (err == 0) err = encode_bf16_map(&to, p.o, p.Dv, p.S, p.H, p.B, p.o_sb,
                                      p.o_sh, p.o_ss, 64);
  if (err != 0) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_bf16_wgmma_kernel<DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  WsParams wp;
  wp.S = p.S;
  wp.H = p.H;
  wp.Hkv = p.Hkv;
  wp.group = p.H / p.Hkv;
  wp.nq = nq;
  wp.causal = p.causal;
  wp.sl2 = p.scale * kLog2e;
  wp.lse = p.lse;
  const dim3 grid(static_cast<unsigned>(blocks));
  flash_bf16_wgmma_kernel<DQK, DV><<<grid, kWsThreads, L::smem, stream>>>(
      tq, tk, tv, to, wp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike). D is the head dim
// of q and k, Dv that of v and o. lse, if not null, receives the (B, H, S)
// f32 log-sum-exp. strides holds the (batch, head, sequence) strides in
// elements of q, k, v and o, in that order; each last dim is dense. The
// caller guarantees 1 <= S, H % Hkv == 0, B * H <= 65535, D and Dv
// multiples of 8 with 8 <= Dv <= D <= 256, 16-byte aligned base pointers,
// and strides that are multiples of 16 bytes and below 2^40 bytes (the
// tensor maps' limits).
int flash_attention_launch(int dtype, const void* q, const void* k,
                           const void* v, void* o, float* lse,
                           const long long* strides,
                           int B, int H, int Hkv, int S, int D, int Dv,
                           float scale, int causal, void* stream) {
  if ((dtype != 0 && dtype != 1) || D > 256 || D % 8 != 0 || Dv < 8 ||
      Dv > D || Dv % 8 != 0 || S < 1 || Hkv < 1 || H % Hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.S = S;
  p.D = D;
  p.Dv = Dv;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {  // bf16: the kernel is chosen by (D, Dv) alone
    if (Dv > 128) return static_cast<int>(launch_bf16_mma(p, s));
    if (D <= 64) return launch_bf16_wgmma<64, 64>(p, s);
    if (D <= 128) return launch_bf16_wgmma<128, 128>(p, s);
    if (D <= 192) return launch_bf16_wgmma<192, 128>(p, s);
    return launch_bf16_wgmma<256, 128>(p, s);
  }
  cudaError_t err;
  if (D <= 32) {
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

const char* flash_attention_error_string(int code) {
  static char buf[96];
  if (code >= kEncodeError) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed (CUresult %d)",
             code - kEncodeError);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
