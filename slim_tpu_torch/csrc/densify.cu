// Densify: runs of a flat (id, value) array -> a dense block (Hopper, sm_90a).
//
// Replaces: slim_tpu/ops/pallas_gram.py · _densify_kernel / pallas_densify.
// Contract: run r (r < R) holds the entries e = starts[r] + k * stride,
// k < lens[r]; entry e has id c = idx[e] and value val[e] (1.0 when val is
// null).  Every id with 0 <= c < limit (limit = min(npad, n_valid)) adds
// its value at (c, r); other ids are dropped; duplicates add.  The block is
// transposed, out[c * ldo + r] ((npad, R), the TPU kernel's layout), or
// row-major, out[r * ldo + c] ((R, npad)).  Each element is written once:
// the call's sum, or with `accumulate` the old value plus the sum, rounded
// once into the output type: float32; int8 from an int32 sum (binary data);
// bfloat16 from a float32 sum, round to nearest even, as the TPU kernel
// casts its float32 tile.  stride 1 reads CSR runs; stride R reads the
// TPU kernel's (W, R) id layout, column r a run.
//
// What bounds it on the H100: the bytes of the dense block, written once
// (the entries are ~1-10% of them).  The old kernel scattered into a
// block the caller had zeroed: a second pass over the block, and one
// read-modify-write of device memory per entry.
//
// Design: a CTA owns a tile of TC output ids x 32 runs.  It zeroes a
// float32 (int32 for int8) accumulator in shared memory; its warps read
// the entries of its runs (coalesced: a warp walks one CSR run 32 entries
// at a time, or, at stride R, the 32 runs side by side, one entry each)
// and add the ids that fall in [c0, c0 + TC) with shared-memory atomics;
// then the tile is written once with 16-byte stores.  Transposed, a tile
// row (one id, 32 runs) is 128 / 64 / 32 bytes of f32 / bf16 / int8, whole
// 32-byte sectors; the accumulator's rows are padded to 33 words so that
// the atomics of one run (one column, many ids) and the write-out (V rows
// x 32 / V chunks a warp) fall on distinct banks.  Row-major, a tile row
// is one run's TC ids.  TC is as large as the shared memory the wrapper
// grants a CTA allows (ops/densify.tile_ids), so each entry is read
// npad / TC times, from L2.  Measured on the H100 (PERF.md), 32 runs a
// tile beat 128-byte bf16 / int8 rows (64 / 128 runs): the accumulator
// is 4 bytes a cell whatever the output, so wider rows cut TC and read
// the entries more often.  The ids need no order within a run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;      // entries in flight per lane
constexpr int kTR = 32;         // runs per tile

template <typename OutT> struct AccOf { using T = float; };
template <> struct AccOf<int8_t> { using T = int; };

__device__ __forceinline__ void acc_add(float* p, float v) { atomicAdd(p, v); }
__device__ __forceinline__ void acc_add(int* p, float v) {
  atomicAdd(p, static_cast<int>(v));
}

// the element written: the sum, or the old value plus the sum, rounded once
__device__ __forceinline__ float finish(float s, float old, bool acc) {
  return acc ? old + s : s;
}
__device__ __forceinline__ int8_t finish(int s, int8_t old, bool acc) {
  return static_cast<int8_t>(acc ? static_cast<int>(old) + s : s);
}
__device__ __forceinline__ __nv_bfloat16 finish(float s, __nv_bfloat16 old,
                                                bool acc) {
  return __float2bfloat16_rn(acc ? __bfloat162float(old) + s : s);
}

// write V consecutive elements (n of them real) at p: one 16-byte store
// when p is aligned and all V are real, else element by element
template <typename OutT, typename AccT, int V>
__device__ __forceinline__ void put(OutT* p, const AccT (&a)[V], int n,
                                    bool acc, bool vec_ok) {
  if (vec_ok && n == V) {
    uint4 w = acc ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
    OutT* o = reinterpret_cast<OutT*>(&w);
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] = finish(a[k], o[k], acc);
    *reinterpret_cast<uint4*>(p) = w;
  } else {
    for (int k = 0; k < n; ++k) p[k] = finish(a[k], acc ? p[k] : OutT(), acc);
  }
}

template <typename OutT, bool kRowMajor>
__global__ void __launch_bounds__(kThreads)
densify_tiles(const int32_t* __restrict__ idx, const float* __restrict__ val,
              const long long* __restrict__ starts,
              const int32_t* __restrict__ lens, long long stride, int R,
              int npad, int limit, int TC, OutT* __restrict__ out,
              long long ldo, int accumulate, int vec_ok) {
  using AccT = typename AccOf<OutT>::T;
  constexpr int V = 16 / static_cast<int>(sizeof(OutT));
  extern __shared__ __align__(16) unsigned char smem_raw[];
  AccT* tile = reinterpret_cast<AccT*>(smem_raw);
  const int ld = kRowMajor ? TC : kTR + 1;       // accumulator row stride
  auto at = [&](int cc, int rr) {
    return kRowMajor ? rr * ld + cc : cc * ld + rr;
  };
  const int words = kRowMajor ? kTR * TC : TC * ld;   // TC % 32 == 0
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * TC;
  const int nC = min(TC, npad - c0);
  const int hi = min(c0 + TC, limit);    // ids in [c0, hi) land here
  const int ntr = (R + kTR - 1) / kTR;

  for (int ty = blockIdx.y; ty < ntr; ty += gridDim.y) {
    const int r0 = ty * kTR;
    const int nR = min(kTR, R - r0);
    for (int i = threadIdx.x * 4; i < words; i += kThreads * 4)
      *reinterpret_cast<int4*>(tile + i) = make_int4(0, 0, 0, 0);
    __syncthreads();

    if (hi > c0 && stride == 1) {
      // a warp per run, its lanes on consecutive entries
      for (int rr = warp; rr < nR; rr += kWarps) {
        const long long s = starts[r0 + rr];
        const int L = lens[r0 + rr];
        for (int k0 = lane; k0 < L; k0 += 32 * kUnroll) {
          int c[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int k = k0 + 32 * u;
            c[u] = k < L ? __ldg(idx + s + k) : -1;
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (c[u] >= c0 && c[u] < hi) {
              const float v = val != nullptr ? __ldg(val + s + k0 + 32 * u)
                                             : 1.0f;
              acc_add(tile + at(c[u] - c0, rr), v);
            }
          }
        }
      }
    } else if (hi > c0) {
      // a lane per run, the warps on entries
      long long s = 0;
      int L = 0;
      if (lane < nR) {
        s = starts[r0 + lane];
        L = lens[r0 + lane];
      }
      const int Lmax = __reduce_max_sync(0xffffffffu, L);
      for (int k0 = warp; k0 < Lmax; k0 += kWarps * kUnroll) {
        int c[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int k = k0 + kWarps * u;
          c[u] = k < L ? __ldg(idx + s + k * stride) : -1;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (c[u] >= c0 && c[u] < hi) {
            const long long e = s + (k0 + kWarps * u) * stride;
            const float v = val != nullptr ? __ldg(val + e) : 1.0f;
            acc_add(tile + at(c[u] - c0, lane), v);
          }
        }
      }
    }
    __syncthreads();

    if constexpr (kRowMajor) {
      // each thread V consecutive ids of one run; a warp covers 32 chunks
      const int chunks = (nC + V - 1) / V;
      for (int t = threadIdx.x; t < nR * chunks; t += kThreads) {
        const int rr = t / chunks, cc = (t - rr * chunks) * V;
        AccT a[V];
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {
          const int4 w =
              *reinterpret_cast<const int4*>(tile + at(cc, rr) + 4 * q);
          const AccT* wa = reinterpret_cast<const AccT*>(&w);
#pragma unroll
          for (int k = 0; k < 4; ++k) a[4 * q + k] = wa[k];
        }
        put<OutT, AccT, V>(out + (r0 + rr) * ldo + c0 + cc, a,
                           min(V, nC - cc), accumulate, vec_ok);
      }
    } else {
      // a warp instruction covers V ids x the tile row's 32 / V chunks of
      // V runs: lane (i, j) reads id row i, runs j V + k: bank i + j V + k
      constexpr int CPI = 32 / V;
      const int i = lane / CPI, col = lane % CPI * V;
      for (int cc = warp * V + i; cc < nC; cc += kWarps * V) {
        if (col >= nR) continue;
        AccT a[V];
#pragma unroll
        for (int k = 0; k < V; ++k) a[k] = tile[at(cc, col + k)];
        put<OutT, AccT, V>(out + (c0 + cc) * ldo + r0 + col, a,
                           min(V, nR - col), accumulate, vec_ok);
      }
    }
    __syncthreads();
  }
}

template <typename OutT, bool kRowMajor>
int launch(const void* idx, const void* val, const void* starts,
           const void* lens, long long stride, int R, int npad, int limit,
           int tc, void* out, long long ldo, int accumulate, cudaStream_t s) {
  const size_t smem =
      static_cast<size_t>(tc) * 4 * (kRowMajor ? kTR : kTR + 1);
  auto kernel = densify_tiles<OutT, kRowMajor>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ntr = (R + kTR - 1) / kTR;
  const dim3 grid((npad + tc - 1) / tc, ntr < 65535 ? ntr : 65535);
  const bool vec_ok = reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                      (ldo * static_cast<long long>(sizeof(OutT))) % 16 == 0;
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(val),
      static_cast<const long long*>(starts), static_cast<const int32_t*>(lens),
      stride, R, npad, limit, tc, static_cast<OutT*>(out), ldo, accumulate,
      vec_ok);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int launch_layout(int row_major, const void* idx, const void* val,
                  const void* starts, const void* lens, long long stride,
                  int R, int npad, int limit, int tc, void* out,
                  long long ldo, int accumulate, cudaStream_t s) {
  return row_major
      ? launch<OutT, true>(idx, val, starts, lens, stride, R, npad, limit, tc,
                           out, ldo, accumulate, s)
      : launch<OutT, false>(idx, val, starts, lens, stride, R, npad, limit,
                            tc, out, ldo, accumulate, s);
}

}  // namespace

// out_kind: 0 = float32, 1 = int8 (binary data only), 2 = bfloat16.
// tc: ids per tile, a multiple of 32 (ops/densify.tile_ids).  One launch.
extern "C" int slim_densify(const void* idx, const void* val,
                            const void* starts, const void* lens,
                            long long stride, int R, int npad, int limit,
                            int out_kind, int row_major, void* out,
                            long long ldo, int accumulate, int tc,
                            void* stream) {
  if (R <= 0 || npad <= 0) return 0;
  if (tc <= 0 || tc % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_kind == 0)
    return launch_layout<float>(row_major, idx, val, starts, lens, stride, R,
                                npad, limit, tc, out, ldo, accumulate, s);
  if (out_kind == 1)
    return launch_layout<int8_t>(row_major, idx, val, starts, lens, stride, R,
                                 npad, limit, tc, out, ldo, accumulate, s);
  return launch_layout<__nv_bfloat16>(row_major, idx, val, starts, lens,
                                      stride, R, npad, limit, tc, out, ldo,
                                      accumulate, s);
}
