// Kernel K2: one slot-attention round (forward), CUDA C++ for sm_90a.
//
// Replaces slotformer_tpu/ops/slot_attention_kernel.py::slot_attention_update
// (Pallas launcher _pallas_forward, body _kernel). For a given pre-scaled q:
//     attn = softmax over the slots of k @ q^T                [B, N, S]
//     upd  = (attn^T @ v + eps * sum_n v) / (sum_n attn + eps * N)   [B, S, D]
// which equals the reference's renormalised weighted mean
// ((attn + eps) / sum_n (attn + eps))^T @ v.
//
// What bounds it: memory traffic. k and v are read once (2 * B*N*D*4 bytes),
// attn is written once (B*N*S*4); the arithmetic is 4*B*N*S*D FLOP, about
// 3.4 FLOP per byte, far below the card's float32 ridge.
//
// Design: split N over blocks, then a second pass (no atomics, so the result
// is the same bit for bit from run to run).
//   1. slot_attention_partial_kernel, grid (ceil(N / TILE_N), B), 256
//      threads. q [S_PAD, D] sits in shared memory (padded rows are zero and
//      masked out of the softmax). Each warp takes whole pixels: its lanes
//      stride over D for the S_PAD dot products, a butterfly reduction leaves
//      every logit in every lane, and the softmax over the valid slots is
//      done in registers. attn is written once to global memory and once to
//      a shared [TILE_N, S_PAD] tile. Then each thread owns feature columns d
//      and streams the tile's v rows (coalesced across threads) into
//      register accumulators num[s][d] and sum_n v[d]; threads 0..S_PAD-1
//      sum den[s]. The block writes its partial num [S_PAD, D], den [S_PAD]
//      and sum_n v [D] to a workspace.
//   2. slot_attention_finish_kernel, grid B: sums the partials of the N
//      tiles in tile order and divides.
// Pixels past N are never read and add nothing; padded slots get zero
// attention and are never written out. All arithmetic is float32.
//
// C interface (bound with ctypes): slot_attention_update_f32 returns the
// cudaError_t of the launches; the caller allocates every buffer, the
// workspace included (slot_attention_update_workspace_floats floats).

#include <cuda_runtime.h>

namespace {

constexpr int S_PAD = 8;
constexpr int TILE_N = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_D = 1024;  // q [S_PAD, D] must fit the 48 KB of static-size shared memory

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(THREADS) slot_attention_partial_kernel(
    const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ q, float* __restrict__ attn_out,
    float* __restrict__ part_num, float* __restrict__ part_den,
    float* __restrict__ part_sumv, int N, int D, int S) {
  extern __shared__ float smem[];
  float* qs = smem;               // [S_PAD, D]
  float* at = qs + S_PAD * D;     // [TILE_N, S_PAD]
  const int tile = blockIdx.x, b = blockIdx.y, n_tiles = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = tile * TILE_N;
  const int tn = min(TILE_N, N - n0);

  for (int i = tid; i < S_PAD * D; i += THREADS)
    qs[i] = i < S * D ? q[(size_t)b * S * D + i] : 0.f;
  __syncthreads();

  // logits and softmax: one warp per pixel
  for (int n = warp; n < tn; n += WARPS) {
    const float* kr = k + ((size_t)b * N + n0 + n) * D;
    float logit[S_PAD];
#pragma unroll
    for (int s = 0; s < S_PAD; ++s) logit[s] = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float kd = __ldg(kr + d);
#pragma unroll
      for (int s = 0; s < S_PAD; ++s) logit[s] = fmaf(kd, qs[s * D + d], logit[s]);
    }
#pragma unroll
    for (int s = 0; s < S_PAD; ++s) logit[s] = warp_sum(logit[s]);
    float m = logit[0];
#pragma unroll
    for (int s = 1; s < S_PAD; ++s)
      if (s < S) m = fmaxf(m, logit[s]);
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < S_PAD; ++s) {
      logit[s] = s < S ? expf(logit[s] - m) : 0.f;
      sum += logit[s];
    }
    const float inv = 1.f / sum;
#pragma unroll
    for (int s = 0; s < S_PAD; ++s) {
      const float a = logit[s] * inv;
      if (lane == s) {
        at[n * S_PAD + s] = a;
        if (s < S) attn_out[((size_t)b * N + n0 + n) * S + s] = a;
      }
    }
  }
  __syncthreads();

  // partial sums over this tile's pixels
  const size_t part = (size_t)b * n_tiles + tile;
  for (int d = tid; d < D; d += THREADS) {
    float num[S_PAD];
#pragma unroll
    for (int s = 0; s < S_PAD; ++s) num[s] = 0.f;
    float sv = 0.f;
    for (int n = 0; n < tn; ++n) {
      const float x = __ldg(v + ((size_t)b * N + n0 + n) * D + d);
      sv += x;
#pragma unroll
      for (int s = 0; s < S_PAD; ++s) num[s] = fmaf(at[n * S_PAD + s], x, num[s]);
    }
#pragma unroll
    for (int s = 0; s < S_PAD; ++s) part_num[(part * S_PAD + s) * D + d] = num[s];
    part_sumv[part * D + d] = sv;
  }
  if (tid < S_PAD) {
    float den = 0.f;
    for (int n = 0; n < tn; ++n) den += at[n * S_PAD + tid];
    part_den[part * S_PAD + tid] = den;
  }
}

__global__ void __launch_bounds__(THREADS) slot_attention_finish_kernel(
    const float* __restrict__ part_num, const float* __restrict__ part_den,
    const float* __restrict__ part_sumv, float* __restrict__ upd_out, int N,
    int D, int S, int n_tiles, float eps) {
  const int b = blockIdx.x;
  const size_t first = (size_t)b * n_tiles;
  for (int i = threadIdx.x; i < S * D; i += THREADS) {
    const int s = i / D, d = i % D;
    float num = 0.f, den = 0.f, sv = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      const size_t part = first + t;
      num += part_num[(part * S_PAD + s) * D + d];
      den += part_den[part * S_PAD + s];
      sv += part_sumv[part * D + d];
    }
    upd_out[(size_t)b * S * D + i] = (num + eps * sv) / (den + eps * (float)N);
  }
}

int n_tiles_of(int N) { return (N + TILE_N - 1) / TILE_N; }

}  // namespace

// Floats of workspace the launch needs: per (batch element, N tile) a
// partial num [S_PAD, D], den [S_PAD] and sum_n v [D].
extern "C" long long slot_attention_update_workspace_floats(int B, int N, int D) {
  return (long long)B * n_tiles_of(N) * (S_PAD * D + S_PAD + D);
}

extern "C" int slot_attention_update_f32(const float* k, const float* v,
                                         const float* q, float* upd_out,
                                         float* attn_out, float* workspace,
                                         int B, int N, int D, int S, float eps,
                                         void* stream) {
  // B is gridDim.y, at most 65535
  if (B < 1 || B > 65535 || N < 1 || D < 1 || D > MAX_D || S < 1 || S > S_PAD)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = n_tiles_of(N);
  float* part_num = workspace;
  float* part_den = part_num + (size_t)B * n_tiles * S_PAD * D;
  float* part_sumv = part_den + (size_t)B * n_tiles * S_PAD;
  const size_t bytes = (size_t)(S_PAD * D + TILE_N * S_PAD) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  slot_attention_partial_kernel<<<dim3(n_tiles, B), THREADS, bytes, st>>>(
      k, v, q, attn_out, part_num, part_den, part_sumv, N, D, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  slot_attention_finish_kernel<<<B, THREADS, 0, st>>>(
      part_num, part_den, part_sumv, upd_out, N, D, S, n_tiles, eps);
  return (int)cudaGetLastError();
}

extern "C" const char* slot_attention_update_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
