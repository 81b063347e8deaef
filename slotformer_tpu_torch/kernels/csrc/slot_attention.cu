// Kernel K1: fused slot attention (forward), CUDA C++ for sm_90a.
//
// Replaces slotformer_tpu/ops/slot_attention_kernel.py::fused_slot_attention
// (Pallas launcher _fused_forward, body _fused_kernel). One call runs all
// num_iterations rounds of
//     q    = LN(h) @ wq * scale
//     attn = softmax over the slots of k @ q^T                [N, S]
//     upd  = (attn^T @ v + eps * sum_n v) / (sum_n attn + eps * N)
//     h    = GRUCell(upd, h)            (flax gates, r/z biases folded)
//     h    = h + MLP(LN(h))
// and writes the slots and the last round's attention.
//
// What bounds it on an H100: bytes. Each round streams k and v once (8 *
// B*N*D bytes); the slot-side math on [8, D] rows is a few MFLOP a batch
// element. At the training batch k and v (268 MB at B=64, N=4096, D=128) do
// not stay in the 50 MB L2 between rounds, so two rounds cost two streams.
// The Pallas kernel gives one program a whole batch element and keeps its k
// and v in fast memory across rounds; here that would leave all but B of the
// 132 SMs idle behind one block's chain of tiles and small matrix products.
//
// Design: 2 * num_iterations + 1 launches on one stream, no atomics and no
// host synchronisation, so the same inputs give the same bits.
//   - fused_slot_attention_sweep_kernel, grid (chunks of N, B), once a
//     round: the sweep of slot_attention_sweep.cuh, shared with kernel K2.
//     It reads that round's q, writes one record (num, sum_n v, den) per
//     chunk and, in the last round only, the attention.
//   - fused_slot_attention_slot_kernel, a thread-block cluster per group of
//     1-5 batch elements, before the first round (q only) and after every
//     round: adds the records in a fixed order, renormalises, runs the GRU
//     and the residual MLP, and computes the next round's q. The five
//     [8, K] x [K, M] products would be a serial walk over 720 KB of
//     weights in one block; instead each of the cluster's blocks owns 1/8
//     of every product's columns, copies just those columns of every weight
//     into its shared memory with 16-byte cp.async at the start of the
//     kernel (all in flight while the records are added), and after each
//     stage writes its slice of the activations into the shared memory of
//     all blocks of the cluster (distributed shared memory), with a cluster
//     barrier between stages. A product splits K over the threads that
//     share a column quad and adds the parts in a fixed order through
//     shared memory. The kernel is a chain of short dependent stages, so it
//     is bound by latency and not by throughput: at a large batch a cluster
//     takes several batch elements through the chain at once (their rows
//     stacked under one copy of the weights) so that the whole batch is one
//     wave of clusters.
// The slot state travels between launches in the workspace ([B, S, D] for q
// and two for h). Padded slot rows (S < 8) are zero on entry, never mix with
// the valid rows and are never written out. All arithmetic is float32.
//
// The GRU weights arrive as [D, 3D] with the three gates of one feature
// side by side (column 3 * d + gate), so a block's features are one
// contiguous run of columns.
//
// C interface (bound with ctypes): fused_slot_attention_f32 returns the
// cudaError_t of the first launch that failed; the caller allocates every
// buffer, the workspace included (fused_slot_attention_workspace_floats).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "slot_attention_sweep.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace slot_sweep;

constexpr float LN_EPS = 1e-6f;
constexpr int MAX_CLUSTER = 8;            // the portable cluster size
constexpr int MAX_GROUP = 5;              // batch elements a cluster takes at once
constexpr size_t MAX_SMEM_BYTES = 232448; // what a block may have on sm_90

// rows of the [N_VECS, D] vector block (kernels/slot_attention.py _VEC_KEYS)
enum { V_QLN_S, V_QLN_B, V_B_IR, V_B_IZ, V_B_IN, V_B_HN, V_MLN_S, V_MLN_B, V_B2 };

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float component(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// y[r, :] = LN(x[r, :]) * g + b for the R rows of [R, D] shared arrays,
// two-pass variance; one warp per row.
__device__ void layernorm_rows(const float* x, float* y, const float* __restrict__ g,
                               const float* __restrict__ b, int R, int D) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < R; r += WARPS) {
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

// Starts the copy of columns [col0, col0 + ncols) of w [K, M] (global) into
// dst [K, ncols] (shared). col0, ncols and M are multiples of 4.
__device__ void copy_weight_slice(float* dst, const float* __restrict__ w, int K,
                                  int M, int col0, int ncols) {
  const int nq = ncols >> 2;
  for (int i = threadIdx.x; i < K * nq; i += THREADS) {
    const int row = i / nq, quad = i % nq;
    cp_async16(dst + row * ncols + 4 * quad, w + (size_t)row * M + col0 + 4 * quad);
  }
}

// y[r, j] = sum_i x[r, i] * w[i, j] for the 8 * G rows of x [8 * G, K], w
// [K, ncols] and y [8 * G, ncols], all in shared memory; K is a multiple of
// 4. Thread (quad, ks, g) takes 4 columns, the 8 rows of group g and every
// KS-th run of 4 consecutive i, so that x as well as w is read in float4s
// (the loop is bound by shared-memory reads, not by the FMAs); g changes
// slowest over the threads, so a warp reads the rows of one group and its
// x reads are broadcasts. The KS parts meet in `red` (product_red_floats
// floats) and are added in ks order. Ends with a block barrier.
__device__ void matmul_slice(const float* x, int K, const float* w, int ncols,
                             float* y, float* red, int G) {
  const int nq = ncols >> 2, K4 = K >> 2;
  const int KS = THREADS / (nq * G);
  const int quad = threadIdx.x % nq, ks = threadIdx.x / nq % KS;
  const int g = threadIdx.x / (nq * KS);
  const int R = S_PAD * G;
  if (g < G) {
    float4 acc[S_PAD];
#pragma unroll
    for (int r = 0; r < S_PAD; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* w4 = reinterpret_cast<const float4*>(w);
    const float4* x4 = reinterpret_cast<const float4*>(x + g * S_PAD * K);
    for (int i4 = ks; i4 < K4; i4 += KS) {
      const float4 w0 = w4[(4 * i4 + 0) * nq + quad];
      const float4 w1 = w4[(4 * i4 + 1) * nq + quad];
      const float4 w2 = w4[(4 * i4 + 2) * nq + quad];
      const float4 w3 = w4[(4 * i4 + 3) * nq + quad];
#pragma unroll
      for (int r = 0; r < S_PAD; ++r) {
        const float4 xv = x4[r * K4 + i4];
        fma4(acc[r], xv.x, w0);
        fma4(acc[r], xv.y, w1);
        fma4(acc[r], xv.z, w2);
        fma4(acc[r], xv.w, w3);
      }
    }
    float4* red4 = reinterpret_cast<float4*>(red);  // [KS, R, ncols]
#pragma unroll
    for (int r = 0; r < S_PAD; ++r)
      red4[((ks * G + g) * S_PAD + r) * nq + quad] = acc[r];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < R * ncols; o += THREADS) {
    float acc = 0.f;
    for (int p = 0; p < KS; ++p) acc += red[p * R * ncols + o];
    y[o] = acc;
  }
  __syncthreads();
}

// Writes val to buf[idx] in the shared memory of every block of the cluster.
__device__ __forceinline__ void broadcast(cg::cluster_group& cluster, float* buf,
                                          int idx, float val) {
  const unsigned n = cluster.num_blocks();
  for (unsigned r = 0; r < n; ++r) cluster.map_shared_rank(buf, r)[idx] = val;
}

// Floats of a product's output slice, for G batch elements.
__host__ __device__ inline int slot_y_floats(int dsl, int hsl, int G) {
  return S_PAD * G * (3 * dsl > hsl ? 3 * dsl : hsl);
}

// Floats of the MLP's hidden layer, which also holds the GRU's second
// output slice [8 * G, 3 * dsl] while it is idle.
__host__ __device__ inline int slot_hid_floats(int dsl, int H, int G) {
  return S_PAD * G * (3 * dsl > H ? 3 * dsl : H);
}

// Floats matmul_slice needs in `red` for a product of ncols columns; 0 if
// the threads of a block do not cover its column quads for G groups.
inline int product_red_floats(int ncols, int G) {
  const int ks = THREADS / (ncols / 4 * G);
  return ks * S_PAD * G * ncols;
}

// Floats of the `red` scratch: the widest product's partial sums or the
// record sum's, whichever is larger; 0 if a product does not fit a block.
inline int slot_red_floats(int dsl, int hsl, int G) {
  const int items = G * (ACC_ROWS * dsl / 4 + 2);
  int floats = 4 * (items < THREADS ? THREADS / items * items : items);
  for (int ncols : {3 * dsl, hsl, dsl}) {
    const int need = product_red_floats(ncols, G);
    if (need == 0) return 0;
    if (need > floats) floats = need;
  }
  return floats;
}

// Floats of a block's weight slices: the GRU's two [D, 3 * dsl], then w1
// [D, hsl], w2 [H, dsl] and wq [D, dsl]. With `overlay` the last three are
// loaded into the GRU's region once the GRU's products have read it, so the
// region holds the larger of the two sets (kernels/slot_attention.py
// slot_smem_floats mirrors this budget).
inline size_t slot_weight_floats(int D, int H, int dsl, int hsl, bool overlay) {
  const size_t gru = (size_t)6 * D * dsl;
  const size_t rest = (size_t)D * hsl + (size_t)H * dsl + (size_t)D * dsl;
  return overlay ? (gru > rest ? gru : rest) : gru + rest;
}

// Shared memory of one block of the slot-side kernel.
inline size_t slot_smem_bytes(int D, int H, int cl, int G, bool overlay) {
  const int dsl = D / cl, hsl = H / cl, R = S_PAD * G;
  const size_t floats = (size_t)3 * R * D + slot_hid_floats(dsl, H, G) +
                        slot_y_floats(dsl, hsl, G) + slot_red_floats(dsl, hsl, G) +
                        slot_weight_floats(D, H, dsl, hsl, overlay);
  return floats * sizeof(float);
}

// Whether a block can hold every weight slice at once only with the
// overlay (D=192, H=384: 264 KB resident, 172 KB overlaid, at most 227 KB).
inline bool slot_overlay(int D, int H, int cl) {
  return slot_smem_bytes(D, H, cl, 1, false) > MAX_SMEM_BYTES;
}

__global__ void __launch_bounds__(THREADS, 2) fused_slot_attention_sweep_kernel(
    const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ q, float* __restrict__ attn_out,
    float* __restrict__ records, int N, int D, int S, int chunk_n) {
  extern __shared__ __align__(16) float smem[];
  const int chunk = blockIdx.x, b = blockIdx.y, n_chunks = gridDim.x;
  const int n_begin = chunk * chunk_n;
  sweep_chunk(k + (size_t)b * N * D, v + (size_t)b * N * D,
              q + (size_t)b * S * D,
              attn_out == nullptr ? nullptr : attn_out + (size_t)b * N * S,
              records + ((size_t)b * n_chunks + chunk) * record_floats(D),
              n_begin, min(N, n_begin + chunk_n), D, S, smem);
}

// Grid (cluster size, ceil(B / G)): one cluster takes batch elements
// blockIdx.y * G .. + G - 1, row 8 * g + s of its arrays being slot s of its
// g-th element. has_update: add the round's records and run GRU + MLP from
// h_in into h_out; want_q: write the next round's q from the resulting state
// (from h_in without an update).
__global__ void __launch_bounds__(THREADS) fused_slot_attention_slot_kernel(
    const float* __restrict__ h_in, const float* __restrict__ records,
    int n_chunks, const float* __restrict__ wq, const float* __restrict__ gru_i,
    const float* __restrict__ gru_h, const float* __restrict__ w1,
    const float* __restrict__ w2, const float* __restrict__ vecs,
    const float* __restrict__ b1, float* __restrict__ h_out,
    float* __restrict__ q_out, int B, int N, int D, int S, int H, int G,
    int red_floats, float scale, float eps, int has_update, int want_q,
    int overlay) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, b0 = blockIdx.y * G;
  const int cl = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int dsl = D / cl, hsl = H / cl;  // this block's columns of D and of H
  const int d0 = rank * dsl, h0 = rank * hsl;
  const int R = S_PAD * G;
  float* hs = smem;                    // [R, D] state on entry, then on exit
  float* hn = hs + R * D;              // [R, D] state after the GRU
  float* xs = hn + R * D;              // [R, D] upd, then LN(state)
  float* hid = xs + R * D;             // [R, H] MLP hidden layer
  float* yb = hid;                     // [R, 3 * dsl] the GRU's hidden-side
                                       // gates: done with before the cluster
                                       // barrier after which hid is written
  float* ya = hid + slot_hid_floats(dsl, H, G);  // a product's output slice
  float* red = ya + slot_y_floats(dsl, hsl, G);  // [red_floats]
  float* wgi_s = red + red_floats;     // [D, 3 * dsl]
  float* wgh_s = wgi_s + D * 3 * dsl;  // [D, 3 * dsl]
  // [D, hsl], [H, dsl], [D, dsl]: after the GRU's slices, or over them
  float* w1_s = overlay ? wgi_s : wgh_s + D * 3 * dsl;
  float* w2_s = w1_s + D * hsl;
  float* wq_s = w2_s + H * dsl;
  // the weight slices of the MLP and of q, loaded at the start or, with the
  // overlay, once the GRU's products have read their region
  auto copy_rest = [&]() {
    if (has_update) copy_weight_slice(w1_s, w1, D, H, h0, hsl);
    cp_async_commit();
    if (has_update) copy_weight_slice(w2_s, w2, H, D, d0, dsl);
    cp_async_commit();
    if (want_q) copy_weight_slice(wq_s, wq, D, D, d0, dsl);
    cp_async_commit();
  };

  // the weight slices in flight: four groups in the order of their use (a
  // group may be empty); the waits below count on that order
  if (has_update) {
    copy_weight_slice(wgi_s, gru_i, D, 3 * D, 3 * d0, 3 * dsl);
    copy_weight_slice(wgh_s, gru_h, D, 3 * D, 3 * d0, 3 * dsl);
  }
  cp_async_commit();
  if (!overlay || !has_update) copy_rest();

  // rows of padded slots and of batch elements past B are zero
  for (int i = tid; i < R * D; i += THREADS) {
    const int row = i / D, b = b0 + row / S_PAD, s = row % S_PAD;
    hs[i] = b < B && s < S ? h_in[((size_t)b * S + s) * D + i % D] : 0.f;
  }

  if (has_update) {
    // this block's columns of the records, added over the chunks: item j of
    // a batch element is a float4 of num (8 rows), of sumv, or of den; the
    // chunks are dealt to `parts` threads an item, then added in part order
    const int rf = record_floats(D);
    const int dq = dsl >> 2, items_per_b = ACC_ROWS * dq + 2, items = G * items_per_b;
    const int parts = items < THREADS ? THREADS / items : 1;
    float4* red4 = reinterpret_cast<float4*>(red);  // [parts, items]
    for (int idx = tid; idx < parts * items; idx += THREADS) {
      const int p = idx / items, item = idx % items;
      const int b = b0 + item / items_per_b, j = item % items_per_b;
      const int off = j < ACC_ROWS * dq ? j / dq * D + d0 + 4 * (j % dq)
                                        : ACC_ROWS * D + 4 * (j - ACC_ROWS * dq);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      if (b < B) {
        const float* rec = records + (size_t)b * n_chunks * rf + off;
        for (int c = p; c < n_chunks; c += parts) {
          const float4 x = __ldg(reinterpret_cast<const float4*>(rec + (size_t)c * rf));
          acc.x += x.x;
          acc.y += x.y;
          acc.z += x.z;
          acc.w += x.w;
        }
      }
      red4[idx] = acc;
    }
    // all blocks of the cluster have started (their shared memory may be
    // written from here on); also this block's barrier for hs and red
    cluster.sync();
    // renormalised weighted mean of v, this block's columns
    for (int o = tid; o < R * dsl; o += THREADS) {
      const int row = o / dsl, dl = o % dsl, g = row / S_PAD, s = row % S_PAD;
      float num = 0.f, sv = 0.f, den = 0.f;
      for (int p = 0; p < parts; ++p) {
        const float4* item = red4 + p * items + g * items_per_b;
        num += component(item[s * dq + dl / 4], dl % 4);
        sv += component(item[S_PAD * dq + dl / 4], dl % 4);
        den += component(item[ACC_ROWS * dq + s / 4], s % 4);
      }
      const bool live = b0 + g < B && s < S;
      broadcast(cluster, xs, row * D + d0 + dl,
                live ? (num + eps * sv) / (den + eps * (float)N) : 0.f);
    }
    cluster.sync();
    // GRU cell: its group is the last one in flight with the overlay
    if (overlay)
      cp_async_wait<0>();
    else
      cp_async_wait<3>();
    __syncthreads();
    matmul_slice(xs, D, wgi_s, 3 * dsl, ya, red, G);
    matmul_slice(hs, D, wgh_s, 3 * dsl, yb, red, G);
    // the GRU's slices are read (matmul_slice ends with a block barrier)
    if (overlay) copy_rest();
    for (int o = tid; o < R * dsl; o += THREADS) {
      const int row = o / dsl, dl = o % dsl, d = d0 + dl;
      const float* gi = ya + row * 3 * dsl + 3 * dl;
      const float* gh = yb + row * 3 * dsl + 3 * dl;
      const float r = sigmoidf(gi[0] + vecs[V_B_IR * D + d] + gh[0]);
      const float z = sigmoidf(gi[1] + vecs[V_B_IZ * D + d] + gh[1]);
      const float c = tanhf(gi[2] + vecs[V_B_IN * D + d] +
                            r * (gh[2] + vecs[V_B_HN * D + d]));
      broadcast(cluster, hn, row * D + d, (1.f - z) * c + z * hs[row * D + d]);
    }
    cluster.sync();
    // residual MLP
    layernorm_rows(hn, xs, vecs + V_MLN_S * D, vecs + V_MLN_B * D, R, D);
    cp_async_wait<2>();
    __syncthreads();
    matmul_slice(xs, D, w1_s, hsl, ya, red, G);
    for (int o = tid; o < R * hsl; o += THREADS) {
      const int row = o / hsl, j = h0 + o % hsl;
      broadcast(cluster, hid, row * H + j, fmaxf(ya[o] + b1[j], 0.f));
    }
    cluster.sync();
    cp_async_wait<1>();
    __syncthreads();
    matmul_slice(hid, H, w2_s, dsl, ya, red, G);
    for (int o = tid; o < R * dsl; o += THREADS) {
      const int row = o / dsl, d = d0 + o % dsl;
      const int b = b0 + row / S_PAD, s = row % S_PAD;
      const float val = hn[row * D + d] + ya[o] + vecs[V_B2 * D + d];
      broadcast(cluster, hs, row * D + d, val);
      if (b < B && s < S) h_out[((size_t)b * S + s) * D + d] = val;
    }
    cluster.sync();  // the last access to another block's shared memory
  } else {
    __syncthreads();
  }

  if (want_q) {
    layernorm_rows(hs, xs, vecs + V_QLN_S * D, vecs + V_QLN_B * D, R, D);
    cp_async_wait<0>();
    __syncthreads();
    matmul_slice(xs, D, wq_s, dsl, ya, red, G);
    for (int o = tid; o < R * dsl; o += THREADS) {
      const int row = o / dsl, d = d0 + o % dsl;
      const int b = b0 + row / S_PAD, s = row % S_PAD;
      if (b < B && s < S) q_out[((size_t)b * S + s) * D + d] = scale * ya[o];
    }
  }
}

// The largest cluster (a power of two up to the portable 8) that cuts both D
// and H into runs of whole float4s.
int cluster_size(int D, int H) {
  for (int cl = MAX_CLUSTER; cl > 1; cl >>= 1)
    if (D % (4 * cl) == 0 && H % (4 * cl) == 0) return cl;
  return 1;
}

// Batch elements a cluster takes at once: as many as make the batch one wave
// of `wave` clusters, as far as a block's threads and shared memory hold
// their rows.
int group_size(int B, int D, int H, int cl, int wave, bool overlay) {
  int g = (B + wave - 1) / wave;
  if (g > MAX_GROUP) g = MAX_GROUP;
  while (g > 1 && (slot_red_floats(D / cl, H / cl, g) == 0 ||
                   slot_smem_bytes(D, H, cl, g, overlay) > MAX_SMEM_BYTES))
    --g;
  return g;
}

// what allow_smem has granted each kernel on each device
size_t sweep_allowed[64], slot_allowed[64];

void slot_launch_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                        cudaStream_t st, int cl, int clusters, size_t bytes) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cl, clusters);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = bytes;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Clusters of the slot-side kernel the current device runs at once (a
// cluster needs its blocks' SMs free within one GPC, so fewer than SMs /
// cluster size), asked when the device or the kernel's footprint changes; one
// block a SM is assumed where the question fails.
int clusters_per_wave(int D, int H, int cl, bool overlay) {
  static int known[64];
  static size_t known_for[64];  // the shared memory and cluster size asked about
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device >= 64) return SM_COUNT / cl;
  const size_t bytes = slot_smem_bytes(D, H, cl, 1, overlay);
  if (known[device] == 0 || known_for[device] != bytes * MAX_CLUSTER + cl) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    slot_launch_config(&cfg, &attr, nullptr, cl, SM_COUNT, bytes);
    int n = 0;
    if (allow_smem(fused_slot_attention_slot_kernel, bytes, slot_allowed) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&n, fused_slot_attention_slot_kernel,
                                       &cfg) != cudaSuccess ||
        n < 1) {
      cudaGetLastError();  // a refused question is not a failed launch
      n = SM_COUNT / cl;
    }
    known[device] = n;
    known_for[device] = bytes * MAX_CLUSTER + cl;
  }
  return known[device];
}

cudaError_t launch_slot_kernel(cudaStream_t st, int cl, size_t bytes,
                               const float* h_in, const float* records,
                               int n_chunks, const float* wq, const float* gru_i,
                               const float* gru_h, const float* w1,
                               const float* w2, const float* vecs,
                               const float* b1, float* h_out, float* q_out,
                               int B, int N, int D, int S, int H, int G,
                               float scale, float eps, int has_update,
                               int want_q, bool overlay) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  slot_launch_config(&cfg, &attr, st, cl, (B + G - 1) / G, bytes);
  const int red_floats = slot_red_floats(D / cl, H / cl, G);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, fused_slot_attention_slot_kernel, h_in, records, n_chunks, wq,
      gru_i, gru_h, w1, w2, vecs, b1, h_out, q_out, B, N, D, S, H, G,
      red_floats, scale, eps, has_update, want_q, (int)overlay);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Floats of workspace a call needs: one record per (batch element, chunk),
// q, and two copies of the slot state.
extern "C" long long fused_slot_attention_workspace_floats(int B, int N, int D,
                                                           int S) {
  return (long long)B * sweep_chunks(N, sweep_chunk_n(B, N)) * record_floats(D) +
         3LL * B * S * D;
}

extern "C" int fused_slot_attention_f32(
    const float* k, const float* v, const float* slots, const float* wq,
    const float* gru_i, const float* gru_h, const float* w1, const float* w2,
    const float* vecs, const float* b1, float* slots_out, float* attn_out,
    float* workspace, int B, int N, int D, int S, int H, int num_iterations,
    float scale, float eps, void* stream) {
  // B is gridDim.y, at most 65535
  if (B < 1 || B > 65535 || N < 1 || D < 4 || D % 4 != 0 || D > MAX_D ||
      H < 4 || H % 4 != 0 || S < 1 || S > S_PAD || num_iterations < 1)
    return (int)cudaErrorInvalidValue;
  const int chunk_n = sweep_chunk_n(B, N);
  const int n_chunks = sweep_chunks(N, chunk_n);
  const int cl = cluster_size(D, H);
  const bool overlay = slot_overlay(D, H, cl);
  // weight slices a block cannot hold even overlaid
  if (slot_smem_bytes(D, H, cl, 1, overlay) > MAX_SMEM_BYTES)
    return (int)cudaErrorInvalidValue;
  const int G = group_size(B, D, H, cl, clusters_per_wave(D, H, cl, overlay), overlay);
  // a product whose column quads outnumber a block's threads (H / cl > 1024)
  if (slot_red_floats(D / cl, H / cl, G) == 0) return (int)cudaErrorInvalidValue;
  const size_t sweep_bytes = sweep_smem_bytes(D);
  const size_t slot_bytes = slot_smem_bytes(D, H, cl, G, overlay);
  cudaError_t err = allow_smem(fused_slot_attention_sweep_kernel, sweep_bytes,
                               sweep_allowed);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(fused_slot_attention_slot_kernel, slot_bytes, slot_allowed);
  if (err != cudaSuccess) return (int)err;

  float* records = workspace;
  float* q = records + (size_t)B * n_chunks * record_floats(D);
  float* state[2] = {q + (size_t)B * S * D, q + (size_t)2 * B * S * D};
  cudaStream_t st = (cudaStream_t)stream;
  err = launch_slot_kernel(st, cl, slot_bytes, slots, records, n_chunks, wq,
                           gru_i, gru_h, w1, w2, vecs, b1, state[0], q, B, N, D,
                           S, H, G, scale, eps, 0, 1, overlay);
  if (err != cudaSuccess) return (int)err;
  const float* h_in = slots;
  for (int it = 0; it < num_iterations; ++it) {
    const bool last = it == num_iterations - 1;
    fused_slot_attention_sweep_kernel<<<dim3(n_chunks, B), THREADS, sweep_bytes, st>>>(
        k, v, q, last ? attn_out : nullptr, records, N, D, S, chunk_n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    float* h_out = last ? slots_out : state[it & 1];
    err = launch_slot_kernel(st, cl, slot_bytes, h_in, records, n_chunks, wq,
                             gru_i, gru_h, w1, w2, vecs, b1, h_out, q, B, N, D,
                             S, H, G, scale, eps, 1, last ? 0 : 1, overlay);
    if (err != cudaSuccess) return (int)err;
    h_in = h_out;
  }
  return (int)cudaSuccess;
}

extern "C" const char* slot_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
