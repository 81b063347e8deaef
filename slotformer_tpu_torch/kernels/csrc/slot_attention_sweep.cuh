// The sweep shared by kernels K1 (slot_attention.cu) and K2
// (slot_attention_update.cu): one block walks a chunk of pixels of one batch
// element and leaves that chunk's share of one slot-attention round,
//     attn[n, s] = softmax over the slots of k[n, :] . q[s, :]
//     num[s, d]  = sum_n attn[n, s] * v[n, d]
//     sumv[d]    = sum_n v[n, d]
//     den[s]     = sum_n attn[n, s]
// as one record of ACC_ROWS * D + S_PAD floats (num rows, then sumv, then
// den). It is the inner loop of both Pallas kernels of
// slotformer_tpu/ops/slot_attention_kernel.py (_kernel and _fused_kernel),
// which walk the N tiles in order on one core and carry num, den and sumv in
// scratch; CUDA blocks run in no order, so every chunk writes a record and a
// second kernel adds the records in chunk order (no atomics: the same inputs
// give the same bits).
//
// What bounds it on an H100: bytes. A round reads k and v once, 8 * N * D
// bytes a batch element, and does 4 FLOP a byte on them, a fifth of what the
// float32 pipes sustain while streaming. So the design is about keeping
// every SM pulling with nothing in the way of the copies:
//   - N is cut into chunks (sweep_chunk_n) so that the (chunks, B) grid covers
//     the card at the extraction batch and the records stay few at the
//     training batch;
//   - k and v tiles of TILE_N pixels are contiguous in memory and come in by
//     16-byte cp.async into two stages of shared memory: the copy of tile
//     t + 1 runs under the arithmetic of tile t;
//   - logits: a warp owns 4 pixels, its lanes stride over D in float4s, so a
//     k value read once feeds all 8 slot sums; a transposing butterfly (31
//     shuffles) leaves one (pixel, slot) logit in each lane, and the softmax
//     over the valid slots is three more shuffles per reduction;
//   - weighted sum: a thread owns one float4 column of v and every
//     (256 / (D/4))-th pixel, and keeps num[8], sumv and den in registers
//     across the whole chunk; the pixel groups are added through shared
//     memory once, at the end of the chunk.
// Pixels past the chunk's end are never read (the last tile is short);
// padded slots (S < 8) get zero attention and are never written out. All
// arithmetic is float32. D must be a multiple of 4 (16-byte copies) and at
// most MAX_D (two stages of k and v tiles in shared memory).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace slot_sweep {

constexpr int S_PAD = 8;
constexpr int TILE_N = 32;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PIX_PER_WARP = TILE_N / WARPS;
constexpr int ACC_ROWS = S_PAD + 1;  // num [S_PAD, D], then sumv [D]
constexpr int MAX_D = 256;
constexpr int SM_COUNT = 132;
static_assert(PIX_PER_WARP * S_PAD == 32, "one (pixel, slot) logit per lane");

// Floats of one chunk's record.
__host__ __device__ inline int record_floats(int D) { return ACC_ROWS * D + S_PAD; }

// Pixels per chunk: 512 where that still leaves two blocks for every SM (the
// training batch: few records), else 128 (the extraction batch: the grid
// covers the card). On an H100 the neighbouring sizes timed alike.
inline int sweep_chunk_n(int B, int N) {
  return (long long)B * N / 512 >= 2 * SM_COUNT ? 512 : 128;
}

inline int sweep_chunks(int N, int chunk_n) { return (N + chunk_n - 1) / chunk_n; }

// Shared memory of one sweep block: q, the attention tile, the warps' den,
// and two stages of k and v tiles, which the end-of-chunk sum reuses.
inline size_t sweep_smem_bytes(int D) {
  const size_t stages = (size_t)4 * TILE_N * D;
  const size_t scratch = (size_t)THREADS * ACC_ROWS * 4;
  return (S_PAD * D + TILE_N * S_PAD + WARPS * S_PAD +
          (stages > scratch ? stages : scratch)) * sizeof(float);
}

// cudaFuncAttributeMaxDynamicSharedMemorySize of a kernel on the current
// device, raised when a launch needs more than any before it (above 48 KB
// only with this opt-in; fails for more than a block may have).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t (&allowed)[64]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && bytes <= allowed[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // refused, not failed: the next launch's check is clean
    return err;
  }
  if (device < 64) allowed[device] = bytes;
  return err;
}

__device__ __forceinline__ void cp_async16(float* smem_dst, const float* gmem_src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `Pending` of this thread's committed groups are in flight.
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

// Starts the copy of `n_float4` float4s of k and of v into one stage.
__device__ __forceinline__ void copy_tile(float* kt, float* vt, const float* kg,
                                          const float* vg, int n_float4) {
  for (int i = threadIdx.x; i < n_float4; i += THREADS) {
    cp_async16(kt + 4 * i, kg + 4 * i);
    cp_async16(vt + 4 * i, vg + 4 * i);
  }
  cp_async_commit();
}

// One step of transpose_reduce: lanes whose bit `Half` is set keep the upper
// half of x[0 .. 2 * Half), the others the lower half, each adding its
// partner's copy. Half is a template argument so that every index into x is
// a constant and x stays in registers.
template <int Half>
__device__ __forceinline__ void transpose_reduce_step(float (&x)[32], bool upper) {
#pragma unroll
  for (int i = 0; i < Half; ++i) {
    const float send = upper ? x[i] : x[i + Half];
    const float keep = upper ? x[i + Half] : x[i];
    x[i] = keep + __shfl_xor_sync(0xffffffffu, send, Half);
  }
}

// x[i] holds this lane's share of value i (i = pixel * S_PAD + slot). On
// return x[0] of lane l is the sum over the warp of value l.
__device__ __forceinline__ void transpose_reduce(float (&x)[32]) {
  const int lane = threadIdx.x & 31;
  transpose_reduce_step<16>(x, lane & 16);
  transpose_reduce_step<8>(x, lane & 8);
  transpose_reduce_step<4>(x, lane & 4);
  transpose_reduce_step<2>(x, lane & 2);
  transpose_reduce_step<1>(x, lane & 1);
}

// Walks pixels [n_begin, n_end) of one batch element. kb, vb: [N, D]; qb:
// [S, D] (pre-scaled); attn_b: [N, S], or null when the attention is not
// wanted; record: record_floats(D) floats. smem: sweep_smem_bytes(D) bytes,
// 16-byte aligned. All THREADS threads of the block must call it.
__device__ void sweep_chunk(const float* __restrict__ kb, const float* __restrict__ vb,
                            const float* __restrict__ qb, float* __restrict__ attn_b,
                            float* __restrict__ record, int n_begin, int n_end,
                            int D, int S, float* smem) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int D4 = D >> 2;
  const int tile_floats = TILE_N * D;
  float* qs = smem;                     // [S_PAD, D]
  float* at = qs + S_PAD * D;           // [TILE_N, S_PAD]
  float* den_s = at + TILE_N * S_PAD;   // [WARPS, S_PAD]
  float* stage = den_s + WARPS * S_PAD; // 2 x (k tile, v tile); later the scratch
  const float4* qs4 = reinterpret_cast<const float4*>(qs);
  const float4* at4 = reinterpret_cast<const float4*>(at);

  const int n_tiles = (n_end - n_begin + TILE_N - 1) / TILE_N;
  copy_tile(stage, stage + tile_floats, kb + (size_t)n_begin * D,
            vb + (size_t)n_begin * D, min(TILE_N, n_end - n_begin) * D4);
  for (int i = tid; i < S_PAD * D4; i += THREADS)
    reinterpret_cast<float4*>(qs)[i] =
        i < S * D4 ? __ldg(reinterpret_cast<const float4*>(qb) + i)
                   : make_float4(0.f, 0.f, 0.f, 0.f);

  // weighted sum: thread (group g, column c) takes pixels g, g + G, ...
  const int G = THREADS / D4;
  const int c = tid % D4, g = tid / D4;
  float4 num[S_PAD];
#pragma unroll
  for (int s = 0; s < S_PAD; ++s) num[s] = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 sv = make_float4(0.f, 0.f, 0.f, 0.f);
  float den = 0.f;  // of (pixel lane >> 3 of the warp's four, slot lane & 7)

  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = n_begin + t * TILE_N;
    const int tn = min(TILE_N, n_end - n0);
    cp_async_wait<0>();
    __syncthreads();  // tile t has landed; everyone is done with tile t - 1
    if (t + 1 < n_tiles) {
      float* next = stage + ((t + 1) & 1) * 2 * tile_floats;
      copy_tile(next, next + tile_floats, kb + (size_t)(n0 + TILE_N) * D,
                vb + (size_t)(n0 + TILE_N) * D,
                min(TILE_N, n_end - n0 - TILE_N) * D4);
    }
    const float4* kt4 =
        reinterpret_cast<const float4*>(stage + (t & 1) * 2 * tile_floats);
    const float4* vt4 = kt4 + TILE_N * D4;

    // logits of the warp's four pixels against the 8 slot rows
    float x[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = 0.f;
    for (int d4 = lane; d4 < D4; d4 += 32) {
      float4 qv[S_PAD];
#pragma unroll
      for (int s = 0; s < S_PAD; ++s) qv[s] = qs4[s * D4 + d4];
#pragma unroll
      for (int p = 0; p < PIX_PER_WARP; ++p) {
        const float4 kv = kt4[(warp * PIX_PER_WARP + p) * D4 + d4];
#pragma unroll
        for (int s = 0; s < S_PAD; ++s) {
          float a = x[p * S_PAD + s];
          a = fmaf(kv.x, qv[s].x, a);
          a = fmaf(kv.y, qv[s].y, a);
          a = fmaf(kv.z, qv[s].z, a);
          a = fmaf(kv.w, qv[s].w, a);
          x[p * S_PAD + s] = a;
        }
      }
    }
    transpose_reduce(x);
    // softmax over the valid slots: the 8 lanes of a pixel
    const int pix = warp * PIX_PER_WARP + (lane >> 3), slot = lane & 7;
    const bool live = slot < S && pix < tn;
    float m = live ? x[0] : -CUDART_INF_F;
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float e = live ? expf(x[0] - m) : 0.f;
    float sum = e;
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float a = live ? e / sum : 0.f;
    at[pix * S_PAD + slot] = a;
    den += a;
    if (live && attn_b != nullptr) attn_b[(size_t)(n0 + pix) * S + slot] = a;
    __syncthreads();  // the attention tile is complete

    if (g < G) {
      for (int n = g; n < tn; n += G) {
        const float4 v4 = vt4[n * D4 + c];
        const float4 a0 = at4[n * 2], a1 = at4[n * 2 + 1];
        fma4(num[0], a0.x, v4);
        fma4(num[1], a0.y, v4);
        fma4(num[2], a0.z, v4);
        fma4(num[3], a0.w, v4);
        fma4(num[4], a1.x, v4);
        fma4(num[5], a1.y, v4);
        fma4(num[6], a1.z, v4);
        fma4(num[7], a1.w, v4);
        sv.x += v4.x;
        sv.y += v4.y;
        sv.z += v4.z;
        sv.w += v4.w;
      }
    }
  }

  // add the pixel groups in group order, the warps' den in warp order
  __syncthreads();  // every copy has landed and every tile has been read
  float4* scratch4 = reinterpret_cast<float4*>(stage);  // [G, ACC_ROWS, D]
  if (g < G) {
#pragma unroll
    for (int s = 0; s < S_PAD; ++s) scratch4[(g * ACC_ROWS + s) * D4 + c] = num[s];
    scratch4[(g * ACC_ROWS + S_PAD) * D4 + c] = sv;
  }
  den += __shfl_xor_sync(0xffffffffu, den, 8);
  den += __shfl_xor_sync(0xffffffffu, den, 16);
  if (lane < S_PAD) den_s[warp * S_PAD + lane] = den;
  __syncthreads();
  for (int o = tid; o < ACC_ROWS * D; o += THREADS) {
    float acc = 0.f;
    for (int gg = 0; gg < G; ++gg) acc += stage[gg * ACC_ROWS * D + o];
    record[o] = acc;
  }
  if (tid < S_PAD) {
    float acc = 0.f;
    for (int w = 0; w < WARPS; ++w) acc += den_s[w * S_PAD + tid];
    record[ACC_ROWS * D + tid] = acc;
  }
}

}  // namespace slot_sweep
