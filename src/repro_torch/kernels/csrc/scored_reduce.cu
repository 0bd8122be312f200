// OSAFL score reduction (paper eqs. 19-20) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/scored_reduce.py
// (_scored_kernel). For the stacked contribution buffer d (U, N), f32 or
// bf16, and the f32 mean (N,) it computes in one pass over d:
//
//     dots[u]  = <d_u, mean>     norms[u] = ||d_u||^2     mean_sq = ||mean||^2
//
// with f32 accumulation, mean_sq counted once.
//
// Bound: bytes of device memory. Every element of d is read once and used in
// two multiply-adds, far below the card's ~20 operations per byte at f32.
// At the main-path shape (U=256, N=3,821,156, f32) d is 3.91 GB, so the
// least time is ~1.17 ms at 3.35 TB/s. The design keeps every byte of d
// moving at full width and nothing else in the way:
//   * the grid tiles (client row) x (chunk of N), so a small cohort (U of
//     1..16) still spreads over the 132 SMs, and a large one runs many
//     short waves with a small tail;
//   * each thread streams 16-byte vectors of d (4 f32 or 8 bf16) with
//     evict-first loads, four in flight per loop trip; ragged row starts
//     and ends (N not a multiple of the vector) take a scalar head and
//     tail, so no padded copy is ever made;
//   * the mean (15 MB at the main shape) is read by every row and stays in
//     the 50 MB L2, so it costs L2 traffic, not device-memory bytes;
//   * block partial sums go to a scratch buffer the caller allocates and a
//     second small kernel adds them in a fixed order: no float atomics, so
//     two runs on the same inputs give bit-identical results.
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float bf16_bits_to_float(unsigned int bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ float load_one(const float* p) { return __ldcs(p); }

__device__ __forceinline__ float load_one(const unsigned short* p) {
  return bf16_bits_to_float(static_cast<unsigned int>(__ldcs(p)));
}

// One 16-byte vector of d at element j (16-byte aligned) against mean[j..].
// The mean is loaded element by element: a row's alignment need not match
// the mean's, and those loads hit L1/L2.
__device__ __forceinline__ void accum_vec(const uint4& raw, const float* m,
                                          float& dot, float& nrm,
                                          const float*) {
  const float x[4] = {__uint_as_float(raw.x), __uint_as_float(raw.y),
                      __uint_as_float(raw.z), __uint_as_float(raw.w)};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float mk = __ldg(m + k);
    dot = fmaf(x[k], mk, dot);
    nrm = fmaf(x[k], x[k], nrm);
  }
}

__device__ __forceinline__ void accum_vec(const uint4& raw, const float* m,
                                          float& dot, float& nrm,
                                          const unsigned short*) {
  const unsigned int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float lo = bf16_bits_to_float(w[k] & 0xffffu);
    const float hi = __uint_as_float(w[k] & 0xffff0000u);
    const float m0 = __ldg(m + 2 * k), m1 = __ldg(m + 2 * k + 1);
    dot = fmaf(lo, m0, dot);
    nrm = fmaf(lo, lo, nrm);
    dot = fmaf(hi, m1, dot);
    nrm = fmaf(hi, hi, nrm);
  }
}

// Sum over the block in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // smem may still be read from a previous call
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += smem[i];
  }
  return s;
}

// Block (c, u) reduces row u of d over columns [c*chunk, min((c+1)*chunk, N))
// and writes part[u][c] (dots), part[U+u][c] (norms) and, for u == 0,
// part[2U][c] (mean_sq). part is (2U+1, nchunks) f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
partial_kernel(const T* __restrict__ d, const float* __restrict__ mean,
               long long U, long long N, long long chunk, long long nchunks,
               float* __restrict__ part) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  __shared__ float smem[kWarps];
  const long long c = blockIdx.x;
  const long long u = blockIdx.y;
  const int t = threadIdx.x;
  const long long c0 = c * chunk;
  const long long c1 = c0 + chunk < N ? c0 + chunk : N;
  const T* row = d + u * N;

  // [c0, a0): scalar head up to the first 16-byte boundary of this row;
  // [a0, a1): whole vectors; [a1, c1): scalar tail.
  const int mis = static_cast<int>(
      (reinterpret_cast<uintptr_t>(row + c0) / sizeof(T)) % V);
  long long a0 = c0 + (mis ? V - mis : 0);
  if (a0 > c1) a0 = c1;
  const long long nvec = (c1 - a0) / V;
  const long long a1 = a0 + nvec * V;

  float dot = 0.f, nrm = 0.f;
  if (t < a0 - c0) {
    const float x = load_one(row + c0 + t);
    const float m = __ldg(mean + c0 + t);
    dot = fmaf(x, m, dot);
    nrm = fmaf(x, x, nrm);
  }
  if (t < c1 - a1) {
    const float x = load_one(row + a1 + t);
    const float m = __ldg(mean + a1 + t);
    dot = fmaf(x, m, dot);
    nrm = fmaf(x, x, nrm);
  }

  const uint4* rv = reinterpret_cast<const uint4*>(row + a0);
  const float* mv = mean + a0;
  long long v = t;
  for (; v + 3 * kThreads < nvec; v += 4 * kThreads) {
    const uint4 r0 = __ldcs(rv + v);
    const uint4 r1 = __ldcs(rv + v + kThreads);
    const uint4 r2 = __ldcs(rv + v + 2 * kThreads);
    const uint4 r3 = __ldcs(rv + v + 3 * kThreads);
    accum_vec(r0, mv + v * V, dot, nrm, d);
    accum_vec(r1, mv + (v + kThreads) * V, dot, nrm, d);
    accum_vec(r2, mv + (v + 2 * kThreads) * V, dot, nrm, d);
    accum_vec(r3, mv + (v + 3 * kThreads) * V, dot, nrm, d);
  }
  for (; v < nvec; v += kThreads) {
    accum_vec(__ldcs(rv + v), mv + v * V, dot, nrm, d);
  }

  float msq = 0.f;
  if (u == 0) {  // ||mean||^2 once, by the blocks of row 0
    for (long long j = c0 + t; j < c1; j += kThreads) {
      const float m = __ldg(mean + j);
      msq = fmaf(m, m, msq);
    }
  }

  dot = block_sum(dot, smem);
  nrm = block_sum(nrm, smem);
  msq = block_sum(msq, smem);
  if (t == 0) {
    part[u * nchunks + c] = dot;
    part[(U + u) * nchunks + c] = nrm;
    if (u == 0) part[2 * U * nchunks + c] = msq;
  }
}

// Block r adds row r of part (2U+1, nchunks) in a fixed order.
__global__ void __launch_bounds__(kThreads)
finalize_kernel(const float* __restrict__ part, long long U,
                long long nchunks, float* __restrict__ dots,
                float* __restrict__ norms, float* __restrict__ mean_sq) {
  __shared__ float smem[kWarps];
  const long long r = blockIdx.x;
  float s = 0.f;
  for (long long c = threadIdx.x; c < nchunks; c += kThreads) {
    s += part[r * nchunks + c];
  }
  s = block_sum(s, smem);
  if (threadIdx.x == 0) {
    if (r < U) {
      dots[r] = s;
    } else if (r < 2 * U) {
      norms[r - U] = s;
    } else {
      mean_sq[0] = s;
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. d is (U, N) row-major, mean (N,) f32,
// part (2U+1, nchunks) f32 scratch, dots/norms (U,) and mean_sq (1,) f32.
// The caller guarantees 1 <= U <= 65535, N >= 1, chunk a multiple of 8 and
// nchunks = ceil(N / chunk).
int scored_reduce_launch(int dtype, const void* d, const float* mean,
                         long long U, long long N, long long chunk,
                         long long nchunks, float* part, float* dots,
                         float* norms, float* mean_sq, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned int>(nchunks),
                  static_cast<unsigned int>(U));
  if (dtype == 0) {
    partial_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(d), mean, U, N, chunk, nchunks, part);
  } else if (dtype == 1) {
    partial_kernel<unsigned short><<<grid, kThreads, 0, s>>>(
        static_cast<const unsigned short*>(d), mean, U, N, chunk, nchunks,
        part);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finalize_kernel<<<static_cast<unsigned int>(2 * U + 1), kThreads, 0, s>>>(
      part, U, nchunks, dots, norms, mean_sq);
  return static_cast<int>(cudaGetLastError());
}

const char* scored_reduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
