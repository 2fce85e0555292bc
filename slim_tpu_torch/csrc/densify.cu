// Transposed densify of one block of padded sparse rows (Hopper, sm_90a).
//
// Replaces: slim_tpu/ops/pallas_gram.py · _densify_kernel / pallas_densify.
// Contract: out[c, r] += v for every entry (idsT[w, r] = c, valsT[w, r] = v)
// with w < wmax[r / RT]; ids outside [0, npad) are sentinels and dropped;
// duplicate ids accumulate.  valsT == nullptr means implicit 1.0 (binary).
// out is (npad, R) with row stride ldo, f32, int8 or bf16 (the TPU kernel's
// out_dtype), zeroed (or holding an earlier pass) by the caller.
//
// What bounds it on the H100: memory traffic.  Reading idsT/valsT is
// coalesced (thread r reads column r of a row-major (W, R) array, so a
// warp reads 32 consecutive words per w); the stores are a scatter, one
// read-modify-write per entry, ~8 bytes each.  The TPU kernel avoided
// scatter with a dense compare-select over every (column tile, entry
// chunk) pair; on Hopper a scatter costs one store per entry, so the work
// drops from O(npad * W * R) compares to O(nnz) stores.
//
// Design: one thread per output column r walks its W entries.  No other
// thread writes column r, so the accumulation needs no atomics and
// duplicates add up in entry order.  A bf16 output adds through f32 and
// rounds once per entry (nearest even): integer sums up to 256 stay exact.
// A block is one RT-row tile and reads that tile's entry bound wmax (the
// densify_meta skip data) to stop early.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RT = 256;  // rows per block == rows per wmax tile

__device__ __forceinline__ void add_to(float* p, float v) { *p += v; }
__device__ __forceinline__ void add_to(int8_t* p, float v) {
  *p = static_cast<int8_t>(*p + static_cast<int>(v));
}
__device__ __forceinline__ void add_to(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(__bfloat162float(*p) + v);
}

template <typename OutT>
__global__ void __launch_bounds__(RT)
densify_kernel(const int32_t* __restrict__ idsT, const float* __restrict__ valsT,
               const int32_t* __restrict__ wmax, int W, int R, int npad,
               OutT* __restrict__ out, long long ldo) {
  const int r = blockIdx.x * RT + threadIdx.x;
  if (r >= R) return;
  int wm = wmax[blockIdx.x];
  if (wm > W) wm = W;
  for (int w = 0; w < wm; ++w) {
    const long long e = static_cast<long long>(w) * R + r;
    const int c = idsT[e];
    if (c < 0 || c >= npad) continue;
    const float v = valsT != nullptr ? valsT[e] : 1.0f;
    add_to(out + static_cast<long long>(c) * ldo + r, v);
  }
}

}  // namespace

// out_kind: 0 = float32, 1 = int8 (binary data only), 2 = bfloat16.
extern "C" int slim_densify(const void* idsT, const void* valsT,
                            const void* wmax, int W, int R, int npad,
                            int out_kind, void* out, long long ldo,
                            void* stream) {
  const dim3 grid((R + RT - 1) / RT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R > 0) {
    if (out_kind == 0) {
      densify_kernel<float><<<grid, RT, 0, s>>>(
          static_cast<const int32_t*>(idsT), static_cast<const float*>(valsT),
          static_cast<const int32_t*>(wmax), W, R, npad,
          static_cast<float*>(out), ldo);
    } else if (out_kind == 1) {
      densify_kernel<int8_t><<<grid, RT, 0, s>>>(
          static_cast<const int32_t*>(idsT), static_cast<const float*>(valsT),
          static_cast<const int32_t*>(wmax), W, R, npad,
          static_cast<int8_t*>(out), ldo);
    } else {
      densify_kernel<__nv_bfloat16><<<grid, RT, 0, s>>>(
          static_cast<const int32_t*>(idsT), static_cast<const float*>(valsT),
          static_cast<const int32_t*>(wmax), W, R, npad,
          static_cast<__nv_bfloat16*>(out), ldo);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
