// Ragged compaction of a solved block for the harvest (Hopper, sm_90a).
//
// Replaces: slim_tpu/ops/pallas_pack.py · _pack_kernel / pallas_pack.
// Contract (cd_kernel.pack_flat): the entries x[b, k] > eps of row b land at
// [off[b], off[b] + cnt[b]) in ascending k, as (value, column id) pairs;
// positions >= Tpad are dropped.  The caller zero-fills vals/ids, so the
// tail [T, Tpad) stays 0.
//
// What bounds it on the H100: reading x once (B*K*4 bytes, 117 MB for a
// (1024, 28672) block, ~40 us at 3.35 TB/s); the writes are only the
// nonzeros.  The TPU kernel built in-group ranks and group prefixes with
// one-hot MXU products; here the rank is a warp ballot + popcount and the
// cross-warp prefix one shared-memory scan per tile.
//
// Design: one block per row b walks the row in ascending tiles of
// blockDim.x columns, keeping the running output position in a register;
// each tile costs two __syncthreads.  Reads are coalesced (consecutive
// threads, consecutive columns) and values are copied bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
pack_kernel(const float* __restrict__ x, const int32_t* __restrict__ off,
            int K, int Tpad, float eps, float* __restrict__ vals,
            int32_t* __restrict__ ids) {
  __shared__ int warp_incl[NWARPS];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wid = tid >> 5;
  const float* row = x + static_cast<long long>(b) * K;
  int run = off[b];
  for (int k0 = 0; k0 < K; k0 += THREADS) {
    const int k = k0 + tid;
    const float v = k < K ? row[k] : 0.0f;
    const bool m = (k < K) && (v > eps);
    const unsigned bal = __ballot_sync(0xffffffffu, m);
    const int rank = __popc(bal & ((1u << lane) - 1u));
    if (lane == 0) warp_incl[wid] = __popc(bal);
    __syncthreads();
    if (wid == 0) {
      int s = lane < NWARPS ? warp_incl[lane] : 0;
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, s, d);
        if (lane >= d) s += t;
      }
      if (lane < NWARPS) warp_incl[lane] = s;
    }
    __syncthreads();
    const int before = wid > 0 ? warp_incl[wid - 1] : 0;
    const int total = warp_incl[NWARPS - 1];
    if (m) {
      const int pos = run + before + rank;
      if (pos >= 0 && pos < Tpad) {
        vals[pos] = v;
        ids[pos] = k;
      }
    }
    run += total;
    __syncthreads();  // warp_incl is rewritten by the next tile
  }
}

}  // namespace

extern "C" int slim_pack(const void* x, const void* off, int B, int K,
                         int Tpad, float eps, void* vals, void* ids,
                         void* stream) {
  if (B > 0) {
    pack_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const int32_t*>(off), K,
        Tpad, eps, static_cast<float*>(vals), static_cast<int32_t*>(ids));
  }
  return static_cast<int>(cudaGetLastError());
}
