// Flash attention (causal or not, grouped-query) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (_flash_kernel, launched by flash_attention_bhsd). For q (B, H, S, D) and
// k, v (B, Hkv, S, D), H a multiple of Hkv, query head h reading kv head
// h / (H / Hkv), it computes
//
//     o[b, h, i] = sum_j softmax_j(scale * <q[b, h, i], k[b, hk, j]>) v[b, hk, j]
//
// over j <= i when causal, with an online softmax: a running row max m and
// row sum l and the output accumulator, all f32, are carried over kv tiles,
// so the (S, S) scores never reach device memory. Masked scores are -1e30
// as in the TPU kernel, and the output is acc / max(l, 1e-30) in q's dtype.
//
// Bound. At the serving path's prefill shape (B=4, S=4096, H=56, Hkv=8,
// D=128, bf16, causal) the two products take 4*B*H*D*S(S+1)/2 = 962 GFLOP,
// 0.97 ms at the H100's 989 TFLOP/s for bf16 tensor cores, while q, k, v and
// o are 0.54 GB, 0.16 ms at 3.35 TB/s: the kernel is bound by operations.
// What the design does about it:
//   * bf16 inputs run both products on the tensor cores (mma.sync m16n8k16,
//     bf16 operands, f32 accumulation); the probabilities are rounded to
//     bf16 for the second product, the softmax statistics stay f32;
//   * a block owns 64 query rows of one (b, h), four warps of 16 rows each,
//     whose q fragments stay in registers, and loops over kv tiles of 64
//     rows (32 at D > 128); each tile of k and v is read from device memory
//     once per block and used by all its rows;
//   * the tiles are double-buffered in shared memory: cp.async brings the
//     next tile in while the warps compute on this one, and ldmatrix (.trans
//     for v) turns the padded, bank-conflict-free rows into mma fragments;
//   * a causal block stops at the diagonal, halving the work, and blocks
//     are issued longest first so the short ones fill the tail;
//   * kv heads are read in place through their own strides: the repeated
//     heads of grouped-query attention are never materialised, and the
//     model-layout (B, S, H, D) views go in without a copy.
// Not yet done (a later speed PR): wgmma and TMA, warp specialisation,
// overlap of the softmax with the next tile's products. f32 inputs take a
// CUDA-core kernel (f32 FMA, exact f32 products as the TPU kernel's) that is
// right, not fast.
//
// Ragged shapes: any S >= 1 (rows and keys past S are masked; nothing is
// padded in memory) and any D that is a multiple of 8 up to 256 (the kernels
// are instantiated for D buckets of 32, 64, 128 and 256 and mask the rest).
// One block owns each output row and no atomics are used, so two runs on
// the same inputs give bit-identical results. The C entry point launches on
// the caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;  // the TPU kernel's mask value
constexpr int kThreads = 128;      // four warps (the f32 kernel)
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_ss;  // strides in elements; the last dim is dense
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int B, H, Hkv, S, D;
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
      const bool in = n0 + r < p.S && c < p.D;
      ks[r * (DP + 1) + c] = in ? k[(n0 + r) * p.k_ss + c] : 0.f;
      vs[r * DP + c] = in ? v[(n0 + r) * p.v_ss + c] : 0.f;
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

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (row0 + r >= p.S) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int c = lane + 32 * i;
      if (c < p.D) o[(row0 + r) * p.o_ss + c] = acc[r][i] / den;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, mma.sync m16n8k16 (bf16 x bf16 -> f32).
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

constexpr int kBf16Warps = 4;  // 16 query rows each

template <int DP>
struct Bf16Tiles {
  static constexpr int BM = 16 * kBf16Warps;
  static constexpr int BN = DP <= 128 ? 64 : 32;
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

  // Stage the k and v rows [n0, n0 + BN) into buffer buf, zeros past S or D.
  auto load_tile = [&](int n0, int buf) {
    uint16_t* kd = kv_smem + buf * 2 * BN * LD;
    uint16_t* vd = kd + BN * LD;
    for (int i = threadIdx.x; i < BN * VPR; i += NTH) {
      const int r = i / VPR, c = (i % VPR) * 8;
      const bool in = n0 + r < p.S && c < p.D;
      cp_async16(kd + r * LD + c, in ? k + (n0 + r) * p.k_ss + c : k, in);
      cp_async16(vd + r * LD + c, in ? v + (n0 + r) * p.v_ss + c : v, in);
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
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int c = d * 8 + 2 * t;
    if (c >= p.D) continue;
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

template <int DP>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  using T = Bf16Tiles<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(T::smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.S + T::BM - 1) / T::BM, p.B * p.H);
  flash_bf16_kernel<DP><<<grid, 32 * kBf16Warps, T::smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch(int dtype, const Params& p, cudaStream_t stream) {
  return dtype == 0 ? launch_f32<DP>(p, stream) : launch_bf16<DP>(p, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike). strides holds the
// (batch, head, sequence) strides in elements of q, k, v and o, in that
// order; each last dim is dense. The caller guarantees 1 <= S,
// H % Hkv == 0, B * H <= 65535, D % 8 == 0 with 8 <= D <= 256, and, for
// bf16, 16-byte aligned base pointers and strides that are multiples of 8.
int flash_attention_launch(int dtype, const void* q, const void* k,
                           const void* v, void* o, const long long* strides,
                           int B, int H, int Hkv, int S, int D, float scale,
                           int causal, void* stream) {
  if ((dtype != 0 && dtype != 1) || D < 8 || D > 256 || D % 8 != 0 || S < 1 ||
      Hkv < 1 || H % Hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_ss = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_ss = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_ss = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_ss = strides[11];
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.S = S;
  p.D = D;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D <= 32) {
    err = launch<32>(dtype, p, s);
  } else if (D <= 64) {
    err = launch<64>(dtype, p, s);
  } else if (D <= 128) {
    err = launch<128>(dtype, p, s);
  } else {
    err = launch<256>(dtype, p, s);
  }
  return static_cast<int>(err);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
