// Kernel K1: fused slot attention (forward), CUDA C++ for sm_90a.
//
// Replaces slotformer_tpu/ops/slot_attention_kernel.py::fused_slot_attention
// (Pallas launcher _fused_forward, body _fused_kernel). One launch runs all
// num_iterations rounds of
//     q    = LN(h) @ wq * scale
//     attn = softmax over the slots of k @ q^T                [N, S]
//     upd  = (attn^T @ v + eps * sum_n v) / (sum_n attn + eps * N)
//     h    = GRUCell(upd, h)            (flax gate layout, [D, 3D] per side)
//     h    = h + MLP(LN(h))
// and writes the slots and the last round's attention.
//
// What bounds it: memory traffic. Each round streams k and v once, 2 rounds
// x 2 x B*N*D*4 bytes, plus B*N*S*4 bytes of attention written in the last
// round; the slot-side math on [8, D] blocks is a few MFLOP. The Pallas
// kernel kept one batch element's k and v (2 MB each at N=4096, D=128) in
// VMEM across rounds. A Hopper block has at most 227 KB of shared memory, so
// this kernel streams k/v in tiles of TILE_N pixels every round instead (the
// second round mostly hits the 50 MB L2 at small B).
//
// Design: one block of 256 threads per batch element. The slot state h, q,
// the accumulators num [8, D], den [8] and sum_n v [D], and the GRU/MLP
// intermediates live in shared memory, padded to S_PAD = 8 slot rows (padded
// rows start at zero, get zero attention and are never written out). Weights
// are read from global memory, each element once per matmul, and stay in L2.
// All arithmetic is float32. One block per batch element leaves most of the
// 132 SMs idle at small B (8 blocks at B=8); splitting N over blocks with a
// second reduction pass is later work.
//
// C interface (bound with ctypes): fused_slot_attention_f32 returns the
// cudaError_t of the launch; the caller allocates every buffer.

#include <cuda_runtime.h>

namespace {

constexpr int S_PAD = 8;
constexpr int TILE_N = 32;
constexpr int THREADS = 256;
constexpr float LN_EPS = 1e-6f;

// rows of the [N_VECS, D] vector block (kernels/slot_attention.py _VEC_KEYS)
enum { V_QLN_S, V_QLN_B, V_B_IR, V_B_IZ, V_B_IN, V_B_HN, V_MLN_S, V_MLN_B, V_B2 };

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// y[r, :] = LN(x[r, :]) * g + b for the S_PAD rows of [S_PAD, D] shared
// arrays, two-pass variance; one warp per row.
__device__ void layernorm_rows(const float* x, float* y, const float* g,
                               const float* b, int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < S_PAD; r += THREADS / 32) {
    const float* xr = x + r * D;
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += xr[d];
    const float mu = warp_sum(s) / D;
    float ss = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float t = xr[d] - mu;
      ss += t * t;
    }
    const float rstd = rsqrtf(warp_sum(ss) / D + LN_EPS);
    for (int d = lane; d < D; d += 32)
      y[r * D + d] = (xr[d] - mu) * rstd * g[d] + b[d];
  }
}

// y[r, j] = alpha * sum_i x[r, i] * w[i, j] for the S_PAD rows of x
// ([S_PAD, K] shared) and w ([K, M] row-major, global). Each thread owns
// whole columns, so every weight is read once and reads are coalesced.
__device__ void matmul_rows(const float* x, int K, const float* __restrict__ w,
                            int M, float* y, int ldy, float alpha) {
  for (int j = threadIdx.x; j < M; j += THREADS) {
    float acc[S_PAD];
#pragma unroll
    for (int r = 0; r < S_PAD; ++r) acc[r] = 0.f;
    for (int i = 0; i < K; ++i) {
      const float wij = __ldg(w + (size_t)i * M + j);
#pragma unroll
      for (int r = 0; r < S_PAD; ++r) acc[r] = fmaf(x[r * K + i], wij, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < S_PAD; ++r) y[r * ldy + j] = alpha * acc[r];
  }
}

__global__ void __launch_bounds__(THREADS) fused_slot_attention_kernel(
    const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ slots, const float* __restrict__ wq,
    const float* __restrict__ gru_i, const float* __restrict__ gru_h,
    const float* __restrict__ w1, const float* __restrict__ w2,
    const float* __restrict__ vecs, const float* __restrict__ b1,
    float* __restrict__ slots_out, float* __restrict__ attn_out, int N, int D,
    int S, int H, int num_iterations, float scale, float eps) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int ldp = D + 1;  // padded rows: conflict-free reads across rows
  float* h = smem;                    // [S_PAD, D]
  float* xs = h + S_PAD * D;          // [S_PAD, D] LN(h) / upd / MLP scratch
  float* q = xs + S_PAD * D;          // [S_PAD, D + 1]
  float* num = q + S_PAD * ldp;       // [S_PAD, D]
  float* sumv = num + S_PAD * D;      // [D]
  float* den = sumv + D;              // [S_PAD]
  float* kt = den + S_PAD;            // [TILE_N, D + 1]
  float* vt = kt + TILE_N * ldp;      // [TILE_N, D]
  float* at = vt + TILE_N * D;        // [TILE_N, S_PAD]
  float* gi = at + TILE_N * S_PAD;    // [S_PAD, 3D]
  float* gh = gi + S_PAD * 3 * D;     // [S_PAD, 3D]
  float* hid = gh + S_PAD * 3 * D;    // [S_PAD, H]

  const float* kb = k + (size_t)b * N * D;
  const float* vb = v + (size_t)b * N * D;
  for (int i = tid; i < S_PAD * D; i += THREADS)
    h[i] = i < S * D ? slots[(size_t)b * S * D + i] : 0.f;
  for (int i = tid; i < D; i += THREADS) sumv[i] = 0.f;
  __syncthreads();

  for (int it = 0; it < num_iterations; ++it) {
    const bool last = it == num_iterations - 1;
    layernorm_rows(h, xs, vecs + V_QLN_S * D, vecs + V_QLN_B * D, D);
    for (int i = tid; i < S_PAD * D; i += THREADS) num[i] = 0.f;
    if (tid < S_PAD) den[tid] = 0.f;
    __syncthreads();
    matmul_rows(xs, D, wq, D, q, ldp, scale);
    __syncthreads();

    for (int n0 = 0; n0 < N; n0 += TILE_N) {
      const int tn = min(TILE_N, N - n0);
      for (int i = tid; i < TILE_N * D; i += THREADS) {
        const int n = i / D, d = i % D;
        const bool ok = n < tn;
        kt[n * ldp + d] = ok ? kb[(size_t)(n0 + n) * D + d] : 0.f;
        vt[n * D + d] = ok ? vb[(size_t)(n0 + n) * D + d] : 0.f;
      }
      __syncthreads();
      // logits: one (pixel, slot) pair per thread
      for (int i = tid; i < TILE_N * S_PAD; i += THREADS) {
        const int n = i / S_PAD, s = i % S_PAD;
        float acc = 0.f;
        if (s < S) {
          const float* kr = kt + n * ldp;
          const float* qr = q + s * ldp;
          for (int d = 0; d < D; ++d) acc = fmaf(kr[d], qr[d], acc);
        }
        at[i] = acc;
      }
      __syncthreads();
      // softmax over the valid slots, one pixel per thread; padded slots and
      // the pixels past N get zero attention
      if (tid < TILE_N) {
        float* a = at + tid * S_PAD;
        if (tid < tn) {
          float m = a[0];
          for (int s = 1; s < S; ++s) m = fmaxf(m, a[s]);
          float sum = 0.f;
          for (int s = 0; s < S; ++s) {
            a[s] = expf(a[s] - m);
            sum += a[s];
          }
          for (int s = 0; s < S; ++s) a[s] = a[s] / sum;
          for (int s = S; s < S_PAD; ++s) a[s] = 0.f;
        } else {
          for (int s = 0; s < S_PAD; ++s) a[s] = 0.f;
        }
      }
      __syncthreads();
      if (last) {
        for (int i = tid; i < tn * S; i += THREADS) {
          const int n = i / S, s = i % S;
          attn_out[((size_t)b * N + n0 + n) * S + s] = at[n * S_PAD + s];
        }
      }
      for (int i = tid; i < S_PAD * D; i += THREADS) {
        const int s = i / D, d = i % D;
        float acc = 0.f;
        for (int n = 0; n < tn; ++n) acc = fmaf(at[n * S_PAD + s], vt[n * D + d], acc);
        num[i] += acc;
      }
      if (it == 0) {
        for (int d = tid; d < D; d += THREADS) {
          float acc = 0.f;
          for (int n = 0; n < tn; ++n) acc += vt[n * D + d];
          sumv[d] += acc;
        }
      }
      if (tid < S_PAD) {
        float acc = 0.f;
        for (int n = 0; n < tn; ++n) acc += at[n * S_PAD + tid];
        den[tid] += acc;
      }
      __syncthreads();
    }

    // renormalized weighted mean of v
    for (int i = tid; i < S_PAD * D; i += THREADS) {
      const int s = i / D, d = i % D;
      xs[i] = (num[i] + eps * sumv[d]) / (den[s] + eps * (float)N);
    }
    __syncthreads();
    // GRU cell
    matmul_rows(xs, D, gru_i, 3 * D, gi, 3 * D, 1.f);
    matmul_rows(h, D, gru_h, 3 * D, gh, 3 * D, 1.f);
    __syncthreads();
    for (int i = tid; i < S_PAD * D; i += THREADS) {
      const int s = i / D, d = i % D;
      const float* gis = gi + s * 3 * D;
      const float* ghs = gh + s * 3 * D;
      const float r = sigmoidf(gis[d] + vecs[V_B_IR * D + d] + ghs[d]);
      const float z = sigmoidf(gis[D + d] + vecs[V_B_IZ * D + d] + ghs[D + d]);
      const float c = tanhf(gis[2 * D + d] + vecs[V_B_IN * D + d] +
                            r * (ghs[2 * D + d] + vecs[V_B_HN * D + d]));
      h[i] = (1.f - z) * c + z * h[i];
    }
    __syncthreads();
    // residual MLP
    layernorm_rows(h, xs, vecs + V_MLN_S * D, vecs + V_MLN_B * D, D);
    __syncthreads();
    matmul_rows(xs, D, w1, H, hid, H, 1.f);
    __syncthreads();
    for (int i = tid; i < S_PAD * H; i += THREADS)
      hid[i] = fmaxf(hid[i] + b1[i % H], 0.f);
    __syncthreads();
    matmul_rows(hid, H, w2, D, xs, D, 1.f);
    __syncthreads();
    for (int i = tid; i < S_PAD * D; i += THREADS)
      h[i] += xs[i] + vecs[V_B2 * D + i % D];
    __syncthreads();
  }
  for (int i = tid; i < S * D; i += THREADS)
    slots_out[(size_t)b * S * D + i] = h[i];
}

}  // namespace

extern "C" int fused_slot_attention_f32(
    const float* k, const float* v, const float* slots, const float* wq,
    const float* gru_i, const float* gru_h, const float* w1, const float* w2,
    const float* vecs, const float* b1, float* slots_out, float* attn_out,
    int B, int N, int D, int S, int H, int num_iterations, float scale,
    float eps, void* stream) {
  if (B < 1 || N < 1 || D < 1 || H < 1 || S < 1 || S > S_PAD ||
      num_iterations < 1)
    return (int)cudaErrorInvalidValue;
  const size_t floats = (size_t)S_PAD * D * 3 + S_PAD * (D + 1) + D + S_PAD +
                        TILE_N * (D + 1) + TILE_N * D + TILE_N * S_PAD +
                        (size_t)S_PAD * 3 * D * 2 + (size_t)S_PAD * H;
  const size_t bytes = floats * sizeof(float);
  // above 48 KB only with this opt-in; fails for more than the 227 KB a
  // block may have
  cudaError_t err = cudaFuncSetAttribute(
      fused_slot_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  fused_slot_attention_kernel<<<B, THREADS, bytes, (cudaStream_t)stream>>>(
      k, v, slots, wq, gru_i, gru_h, w1, w2, vecs, b1, slots_out, attn_out, N,
      D, S, H, num_iterations, scale, eps);
  return (int)cudaGetLastError();
}

extern "C" const char* slot_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
