// Kernel K2: one slot-attention round (forward), CUDA C++ for sm_90a.
//
// Replaces slotformer_tpu/ops/slot_attention_kernel.py::slot_attention_update
// (Pallas launcher _pallas_forward, body _kernel). For a given pre-scaled q:
//     attn = softmax over the slots of k @ q^T                [B, N, S]
//     upd  = (attn^T @ v + eps * sum_n v) / (sum_n attn + eps * N)   [B, S, D]
// which equals the reference's renormalised weighted mean
// ((attn + eps) / sum_n (attn + eps))^T @ v.
//
// What bounds it on an H100: bytes. k and v are read once (8 * B*N*D bytes),
// attn is written once (4 * B*N*S); the arithmetic is 4*B*N*S*D FLOP, about
// 3.4 FLOP a byte, far below the card's float32 ridge. The kernel is as fast
// as the card streams k and v through it.
//
// Design: two launches, no atomics, so the same inputs give the same bits.
//   1. slot_attention_update_sweep_kernel, grid (chunks of N, B): the shared
//      sweep of slot_attention_sweep.cuh (cp.async-staged tiles, logits with
//      8 slot sums per k value, softmax in registers, accumulators in
//      registers across the chunk). It writes attn, and one record (num,
//      sum_n v, den) per chunk of 128 or 512 pixels.
//   2. slot_attention_update_finish_kernel, grid (S*D / 128, B): one output
//      per thread; adds the records in chunk order and divides.
//
// C interface (bound with ctypes): slot_attention_update_f32 returns the
// cudaError_t of the first launch that failed; the caller allocates every
// buffer, the workspace included (slot_attention_update_workspace_floats).

#include <cuda_runtime.h>

#include "slot_attention_sweep.cuh"

namespace {

using namespace slot_sweep;

constexpr int FINISH_THREADS = 128;

__global__ void __launch_bounds__(THREADS, 2) slot_attention_update_sweep_kernel(
    const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ q, float* __restrict__ attn_out,
    float* __restrict__ records, int N, int D, int S, int chunk_n) {
  extern __shared__ __align__(16) float smem[];
  const int chunk = blockIdx.x, b = blockIdx.y, n_chunks = gridDim.x;
  const int n_begin = chunk * chunk_n;
  sweep_chunk(k + (size_t)b * N * D, v + (size_t)b * N * D,
              q + (size_t)b * S * D, attn_out + (size_t)b * N * S,
              records + ((size_t)b * n_chunks + chunk) * record_floats(D),
              n_begin, min(N, n_begin + chunk_n), D, S, smem);
}

__global__ void __launch_bounds__(FINISH_THREADS) slot_attention_update_finish_kernel(
    const float* __restrict__ records, float* __restrict__ upd_out, int N,
    int D, int S, int n_chunks, float eps) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * FINISH_THREADS + threadIdx.x;
  if (i >= S * D) return;
  const int s = i / D, d = i % D;
  const float* rec = records + (size_t)b * n_chunks * record_floats(D);
  float num = 0.f, den = 0.f, sv = 0.f;
  for (int c = 0; c < n_chunks; ++c, rec += record_floats(D)) {
    num += rec[s * D + d];
    sv += rec[S_PAD * D + d];
    den += rec[ACC_ROWS * D + s];
  }
  upd_out[(size_t)b * S * D + i] = (num + eps * sv) / (den + eps * (float)N);
}

}  // namespace

// Floats of workspace the launch needs: one record per (batch element,
// chunk).
extern "C" long long slot_attention_update_workspace_floats(int B, int N, int D) {
  return (long long)B * sweep_chunks(N, sweep_chunk_n(B, N)) * record_floats(D);
}

extern "C" int slot_attention_update_f32(const float* k, const float* v,
                                         const float* q, float* upd_out,
                                         float* attn_out, float* workspace,
                                         int B, int N, int D, int S, float eps,
                                         void* stream) {
  // B is gridDim.y, at most 65535
  if (B < 1 || B > 65535 || N < 1 || D < 4 || D % 4 != 0 || D > MAX_D ||
      S < 1 || S > S_PAD)
    return (int)cudaErrorInvalidValue;
  const int chunk_n = sweep_chunk_n(B, N);
  const int n_chunks = sweep_chunks(N, chunk_n);
  const size_t bytes = sweep_smem_bytes(D);
  static size_t allowed[64];
  cudaError_t err = allow_smem(slot_attention_update_sweep_kernel, bytes, allowed);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  slot_attention_update_sweep_kernel<<<dim3(n_chunks, B), THREADS, bytes, st>>>(
      k, v, q, attn_out, workspace, N, D, S, chunk_n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = (S * D + FINISH_THREADS - 1) / FINISH_THREADS;
  slot_attention_update_finish_kernel<<<dim3(blocks, B), FINISH_THREADS, 0, st>>>(
      workspace, upd_out, N, D, S, n_chunks, eps);
  return (int)cudaGetLastError();
}

extern "C" const char* slot_attention_update_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
