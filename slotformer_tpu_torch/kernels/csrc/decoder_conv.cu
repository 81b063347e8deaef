// Kernel K3: the SAVi decoder's 5x5 stride-1 transposed convolution, 64 -> 64
// channels, in float32 on the tensor cores. CUDA C++ for sm_90a.
//
// It replaces no TPU kernel: the JAX package leaves this layer to XLA. It
// exists because this one layer holds ~74% of the decoder's multiply-adds
// (419.4M of 564.6M an image at 64x64) and the decoder sets the pace of
// SlotFormer training, StoSAVi training and the test_vp rollout. cuDNN runs
// it in float32 on the SIMT units (an FFT convolution for the forward, an
// implicit GEMM for the input gradient).
//
// One template, two uses, both "conv2d, 5x5, padding 2, 64 -> 64 channels"
// over float32 activations in channels-last memory ([N, H, W, 64], what the
// decoder's layers hand each other) with the weight packed by
// kernels/decoder_conv.py:
//   forward     y  = relu(conv_transpose2d(x, W, b, stride 1, padding 2))
//                  = relu(conv2d(x, W flipped, in/out swapped) + b)
//   input grad  dx = conv2d(g * [y > 0], W, padding 2)
//               (the ReLU's mask is applied as the input is loaded; no bias
//               and no ReLU in the epilogue)
//
// float32 from TF32: every operand v is split into hi = tf32(v) and
// lo = tf32(v - hi) (each rounded to nearest, ties away: |v - hi - lo| <=
// 2^-22 |v|), and a product is lo_a*hi_b + hi_a*lo_b + hi_a*hi_b, the two
// small terms summed before the large one. lo_a*lo_b (<= 2^-22 |ab|) is
// left out. Weights arrive split; activations are split in registers as they
// are read from shared memory.
//
// The sums: the tensor core truncates each sum it writes to the precision
// of its accumulator. Summed into the running total directly, the
// truncations of 600 products at the total's magnitude bias the result ~30x
// past float32's error; summed a chunk of 8 input channels at a time into
// the total, the 200 rounded adds still hold ~3x the error of cuDNN's
// float32 FFT convolution. So each chunk's 3 products go into a zeroed
// partial, a float32 add (round to nearest) takes the partial into the sum
// of its kernel row (40 adds at the row's magnitude), and each row's sum
// goes into the total (5 adds).
//
// What bounds it on an H100: operations. At the rollout call's 2352 images
// of 64x64 the layer is 1.973 TFLOP of float32 work, three TF32 products
// each: at the 495 TFLOP/s dense TF32 rate that is 12.0 ms, against 1.4 ms
// for its 4.7 GB of input and output at 3.35 TB/s. The design keeps the
// tensor cores fed and device memory out of the way:
//   - An implicit GEMM: M = output pixels, N = 64 output channels,
//     K = 64 input channels x 25 taps, on warpgroup products
//     (wgmma.m64n64k8.tf32, A from registers, B from shared memory), the only
//     route to the card's full TF32 rate.
//   - A block owns a tile of 4 output rows x 64 columns for all 64 output
//     channels. Its zero-padded input halo (8 rows x 68 columns x 64
//     channels, 148 KB of shared memory) serves all 25 taps as shifted
//     windows.
//   - The split weights (800 KB, L2-resident) stream through shared memory a
//     tap (32 KB) at a time, double-buffered with cp.async, already in the
//     layout wgmma reads (K-major, no swizzle: 8 x 4 core matrices).
//   - 2 warpgroups: warpgroup w owns output rows 2w and 2w + 1 of the tile,
//     one m64 x n64 product each. A warpgroup waits for its products before
//     it adds their partial up; the other warpgroup's products run
//     meanwhile.
//   - A persistent grid, one block on each SM, walks a run of consecutive
//     tiles down a column strip of an image. The halo is a ring of 8 row
//     slots: the next tile's halo shares 4 rows with this one's, and its 4
//     new rows are fetched with cp.async into the slots this tile has
//     finished with while it computes (the input gradient's ReLU mask is
//     applied once a row has landed). Each input element then comes from
//     device memory about once, and the tensor cores do not wait for it.
//   - A halo pixel's channels are padded to 68 floats (4 mod 32 banks), so
//     the A fragments (8 pixels x 4 channels a load) read shared memory
//     without bank conflicts.
//
// C interface (bound with ctypes): each entry point returns the cudaError_t of
// its launch; the caller allocates every buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;           // input and output channels
constexpr int KS = 5;           // kernel size; padding KS / 2
constexpr int TAPS = KS * KS;
constexpr int ROWS = 4;         // output rows of a tile
constexpr int COLS = 64;        // output columns of a tile: one m64 product
constexpr int HALO_ROWS = ROWS + KS - 1;
constexpr int HALO_COLS = COLS + KS - 1;  // input columns x0 - 2 .. x0 + 65
constexpr int CP = C + 4;       // floats a halo pixel takes: 68 = 4 mod 32 banks
constexpr int HALO_FLOATS = HALO_ROWS * HALO_COLS * CP;
constexpr int CHUNKS = C / 8;   // k8 chunks of input channels
// one (chunk, hi or lo) slab of a tap's packed weight: 64 x 8, 2 KB
constexpr int SLAB_BYTES = C * 8 * 4;
constexpr int TAP_F4 = CHUNKS * 2 * SLAB_BYTES / 16;  // float4s of one tap
constexpr int THREADS = 256;    // 2 warpgroups
// a halo row of the ReLU's output, staged for the input gradient's mask
constexpr int STAGE_FLOATS = HALO_COLS * C;
constexpr size_t SMEM_BYTES =
    sizeof(float) * (HALO_FLOATS + STAGE_FLOATS) + 2 * sizeof(float4) * TAP_F4;
static_assert(CP % 32 == 4 && CP % 4 == 0, "halo pixels must start 4 banks apart");
static_assert(SMEM_BYTES <= 232448, "more shared memory than a block may have");
// the weight slab's core matrices (8 output channels x 4 input channels,
// 128 B each): the next 4 input channels 128 B on, the next 8 output
// channels 256 B on
constexpr uint32_t LBO_BYTES = 128, SBO_BYTES = 256;

__device__ __forceinline__ uint32_t tf32_round(float v) {
  // round to nearest, ties away from zero, at TF32's 10 mantissa bits
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// wgmma matrix descriptor of a K-major slab without swizzle
__device__ __forceinline__ uint64_t slab_desc(uint32_t smem_addr) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)(LBO_BYTES >> 4) << 16) |
         ((uint64_t)(SBO_BYTES >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending) : "memory");
}

// Keep the compiler from touching (or reusing) an async product's registers
// before they are waited for: its accumulator and its A fragments.
__device__ __forceinline__ void fence_operand(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_operand(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int c = 0; c < N; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[c][e])::"memory");
}

// d (+)= a * b: a 64 x 8 from the warpgroup's registers, b 8 x 64 from
// shared memory; scale_d 0 starts d from zero.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem_dst)),
               "l"(gmem_src)
               : "memory");
}

// copies 16 bytes, or writes 16 zero bytes where !valid
__device__ __forceinline__ void cp_async16_or_zero(void* smem_dst, const void* gmem_src,
                                                   bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem_dst)),
               "l"(gmem_src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// what threads wrote to shared memory becomes visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void load_tap(float4* dst, const float4* __restrict__ wpack,
                                         int tap) {
  const float4* src = wpack + (size_t)tap * TAP_F4;
#pragma unroll
  for (int i = threadIdx.x; i < TAP_F4; i += THREADS) cp_async16(dst + i, src + i);
  cp_async_commit();
}

// The tile's input halo, [HALO_ROWS][HALO_COLS][CP], zero outside the image;
// with INPUT_GRAD the loaded gradient is masked by [y > 0]. A pixel's 64
// channels are contiguous in device memory (channels last): 16 threads copy
// one pixel in float4s. Halo row h of the tile lies in row slot h.
template <bool INPUT_GRAD>
__device__ __forceinline__ void load_halo(float* halo, const float* __restrict__ in,
                                          const float* __restrict__ relu_out, int n,
                                          int y0, int x0, int H, int W) {
  constexpr int Q = C / 4;
  constexpr int ITEMS = HALO_ROWS * HALO_COLS * Q;
  constexpr int BATCH = 17;
  static_assert(ITEMS % (THREADS * BATCH) == 0, "halo items must split evenly");
  for (int i0 = threadIdx.x; i0 < ITEMS; i0 += THREADS * BATCH) {
    float4 v[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int item = i0 + b * THREADS;
      const int q = item % Q, px = item / Q;
      const int iy = y0 - KS / 2 + px / HALO_COLS, ix = x0 - KS / 2 + px % HALO_COLS;
      v[b] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
        const size_t off = (((size_t)n * H + iy) * W + ix) * C + 4 * q;
        v[b] = __ldg(reinterpret_cast<const float4*>(in + off));
        if (INPUT_GRAD) {
          const float4 m = __ldg(reinterpret_cast<const float4*>(relu_out + off));
          v[b].x = m.x > 0.f ? v[b].x : 0.f;
          v[b].y = m.y > 0.f ? v[b].y : 0.f;
          v[b].z = m.z > 0.f ? v[b].z : 0.f;
          v[b].w = m.w > 0.f ? v[b].w : 0.f;
        }
      }
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int item = i0 + b * THREADS;
      *reinterpret_cast<float4*>(halo + (item / Q) * CP + 4 * (item % Q)) = v[b];
    }
  }
}

// One input row iy of the next tile's halo into row slot `slot`, in flight
// (cp.async, zero outside the image) while the current tile computes. With
// INPUT_GRAD the row of the ReLU's output goes to `stage` beside it; the
// same thread masks its own 16-byte pieces once they have landed
// (mask_row), so no barrier stands between.
constexpr int ROW_ITEMS = HALO_COLS * (C / 4);

template <bool INPUT_GRAD>
__device__ __forceinline__ void fetch_row(float* halo, float* stage,
                                          const float* __restrict__ in,
                                          const float* __restrict__ relu_out, int n, int iy,
                                          int x0, int H, int W, int slot) {
  for (int item = threadIdx.x; item < ROW_ITEMS; item += THREADS) {
    const int q = item % (C / 4), px = item / (C / 4);
    const int ix = x0 - KS / 2 + px;
    const bool valid = iy >= 0 && iy < H && ix >= 0 && ix < W;
    const size_t off = valid ? (((size_t)n * H + iy) * W + ix) * C + 4 * q : 0;
    cp_async16_or_zero(halo + (slot * HALO_COLS + px) * CP + 4 * q, in + off, valid);
    if (INPUT_GRAD) cp_async16_or_zero(stage + 4 * item, relu_out + off, valid);
  }
  cp_async_commit();
}

__device__ __forceinline__ void mask_row(float* halo, const float* stage, int slot) {
  for (int item = threadIdx.x; item < ROW_ITEMS; item += THREADS) {
    float4* gv = reinterpret_cast<float4*>(
        halo + (slot * HALO_COLS + item / (C / 4)) * CP + 4 * (item % (C / 4)));
    const float4 m = *reinterpret_cast<const float4*>(stage + 4 * item);
    float4 v = *gv;
    v.x = m.x > 0.f ? v.x : 0.f;
    v.y = m.y > 0.f ? v.y : 0.f;
    v.z = m.z > 0.f ? v.z : 0.f;
    v.w = m.w > 0.f ? v.w : 0.f;
    *gv = v;
  }
}

// Input channels one group of products takes, in chunks of 8: a group sums
// its 3 x CPG products in a zeroed partial before one rounded add.
constexpr int CPG = 4;
constexpr int GROUPS = CHUNKS / CPG;  // groups of a tap, per output row
static_assert(CHUNKS % CPG == 0, "chunks must split into whole groups");

// The A fragments of one output row's group (m64 x k8 each): this thread's 4
// values a chunk (pixels g and g + 8 of its warp's 16, channels t and
// t + 4), as read from the halo.
__device__ __forceinline__ void load_a(float (&v)[CPG][4], const float* a) {
#pragma unroll
  for (int c = 0; c < CPG; ++c) {
    v[c][0] = a[8 * c];
    v[c][1] = a[8 * CP + 8 * c];
    v[c][2] = a[4 + 8 * c];
    v[c][3] = a[8 * CP + 4 + 8 * c];
  }
}

__device__ __forceinline__ void split_a(uint32_t (&ah)[CPG][4], uint32_t (&al)[CPG][4],
                                        const float (&v)[CPG][4]) {
#pragma unroll
  for (int c = 0; c < CPG; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ah[c][e] = tf32_round(v[c][e]);
      al[c][e] = tf32_round(v[c][e] - __uint_as_float(ah[c][e]));
    }
}

// One group's products for one output row into a zeroed partial: all lo*hi,
// then all hi*lo, then all hi*hi. w_group: the group's first (chunk, hi)
// slab; a chunk's lo slab follows its hi slab.
__device__ __forceinline__ void group_products(float (&part)[32], const uint32_t (&ah)[CPG][4],
                                               const uint32_t (&al)[CPG][4], uint32_t w_group) {
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < CPG; ++c)
    wgmma_tf32(part, al[c], slab_desc(w_group + 2 * c * SLAB_BYTES), c > 0);
#pragma unroll
  for (int c = 0; c < CPG; ++c)
    wgmma_tf32(part, ah[c], slab_desc(w_group + (2 * c + 1) * SLAB_BYTES), 1);
#pragma unroll
  for (int c = 0; c < CPG; ++c)
    wgmma_tf32(part, ah[c], slab_desc(w_group + 2 * c * SLAB_BYTES), 1);
  wgmma_commit();
}

__device__ __forceinline__ void add_to(float (&sum)[32], float (&part)[32]) {
  fence_operand(part);
#pragma unroll
  for (int i = 0; i < 32; ++i) sum[i] += part[i];
}

template <bool INPUT_GRAD>
__global__ void __launch_bounds__(THREADS, 1)
    decoder_conv_s1_kernel(const float* __restrict__ in, const float* __restrict__ relu_out,
                           const float4* __restrict__ wpack, const float* __restrict__ bias,
                           float* __restrict__ out, int N, int H, int W) {
  extern __shared__ __align__(128) float smem[];
  float* halo = smem;
  float* stage = smem + HALO_FLOATS;
  float4* wbuf = reinterpret_cast<float4*>(stage + STAGE_FLOATS);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // groupID, thread in group
  const int wg = warp / 4, wq = warp % 4;  // warpgroup, warp within it
  const int tiles_x = (W + COLS - 1) / COLS, tiles_y = (H + ROWS - 1) / ROWS;
  const int tiles = N * tiles_y * tiles_x;  // < 2^31 (launch)
  // A block takes a run of consecutive tiles; tile = (n * tiles_x + cb) *
  // tiles_y + rb, so the next tile is mostly the one below, whose halo
  // shares 4 rows with this one's: only its 4 new rows are fetched, each
  // into the row slot that this tile has finished with.
  const int first = (int)((long long)tiles * blockIdx.x / gridDim.x);
  const int last = (int)((long long)tiles * (blockIdx.x + 1) / gridDim.x);
  // A fragment a0 at tap (0, 0) and chunk 0 of this thread's output row's
  // halo row: column 16 wq + g (output column x0 + 16 wq + g reads input
  // x0 + 16 wq + g - 2 at kx = 0), channel t
  const float* a_thread = halo + (16 * wq + g) * CP + t;
  const uint32_t wbuf_s = smem_u32(wbuf);

  int buf = 0, base = 0;  // base: the row slot of the tile's halo row 0
  bool fetched = false;   // the tile's new rows were fetched during the last tile
  load_tap(wbuf, wpack, 0);
  for (int tile = first; tile < last; ++tile) {
    const int rb = tile % tiles_y, strip = tile / tiles_y;
    const int cb = strip % tiles_x, n = strip / tiles_x;
    const int y0 = rb * ROWS, x0 = cb * COLS;
    const bool fetch_next = tile + 1 < last && rb + 1 < tiles_y;
    if (!fetched) {
      base = 0;
      load_halo<INPUT_GRAD>(halo, in, relu_out, n, y0, x0, H, W);
    }

    float acc[2][32], row_sum[2][32], part[32];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;

    for (int ky = 0; ky < KS; ++ky) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 32; ++i) row_sum[m][i] = 0.f;
      // halo rows 2 wg + ky and 2 wg + 1 + ky of this warpgroup's two output
      // rows
      const float* a_row[2] = {
          a_thread + ((base + 2 * wg + ky) % HALO_ROWS) * HALO_COLS * CP,
          a_thread + ((base + 2 * wg + 1 + ky) % HALO_ROWS) * HALO_COLS * CP};
      for (int kx = 0; kx < KS; ++kx) {
        const int tap = ky * KS + kx;
        cp_async_wait_all();
        // the row fetched at this kernel row's first tap has landed
        if (INPUT_GRAD && fetch_next && ky > 0 && kx == 1)
          mask_row(halo, stage, (base + ky - 1) % HALO_ROWS);
        fence_async_shared();
        __syncthreads();  // this tap's weights (and the halo) are in; tap - 1 is done
        load_tap(wbuf + (buf ^ 1) * TAP_F4, wpack, tap + 1 < TAPS ? tap + 1 : 0);
        // halo row ky - 1 is done with: the next tile's halo row ky + 3
        // (input row y0 + 4 - 2 + ky + 3) goes into its slot
        if (fetch_next && ky > 0 && kx == 0)
          fetch_row<INPUT_GRAD>(halo, stage, in, relu_out, n, y0 + ky + 5, x0, H, W,
                                (base + ky - 1) % HALO_ROWS);
        const uint32_t w_tap = wbuf_s + buf * TAP_F4 * 16;
        // Group gi of row m is step 2 gi + m: split the A fragments read the
        // step before, issue the products, read the next step's A fragments
        // while they run, wait, and add the partial into the row's sum. The
        // accumulator is read only after all products are waited for (else
        // ptxas serializes them); the other warpgroup's products fill the
        // tensor cores meanwhile.
        float v[CPG][4];
        load_a(v, a_row[0] + kx * CP);
#pragma unroll
        for (int gi = 0; gi < GROUPS; ++gi) {
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            uint32_t ah[CPG][4], al[CPG][4];
            split_a(ah, al, v);
            fence_operand(part);
            group_products(part, ah, al, w_tap + 2 * gi * CPG * SLAB_BYTES);
            if (m == 0)
              load_a(v, a_row[1] + kx * CP + gi * CPG * 8);
            else if (gi + 1 < GROUPS)
              load_a(v, a_row[0] + kx * CP + (gi + 1) * CPG * 8);
            wgmma_wait<0>();
            fence_operand(ah);
            fence_operand(al);
            add_to(row_sum[m], part);
          }
        }
        buf ^= 1;
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[m][i] += row_sum[m][i];
    }
    // the next tile's new rows (its halo rows 4..7) wait in the slots of
    // this tile's rows 0..3
    fetched = fetch_next;

    // accumulator registers 4 i .. 4 i + 3 of output row 2 wg + m: pixels
    // 16 wq + g (and + 8), channels 8 i + 2t, 8 i + 2t + 1. Channels last:
    // two channels are one float2.
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int oy = y0 + 2 * wg + m;
      if (oy >= H) continue;
      float* row = out + ((size_t)n * H + oy) * W * C;
#pragma unroll
      for (int i = 0; i < C / 8; ++i) {
        const int co = 8 * i + 2 * t;
        const float2 bi = INPUT_GRAD ? make_float2(0.f, 0.f)
                                     : __ldg(reinterpret_cast<const float2*>(bias + co));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = x0 + 16 * wq + 8 * h + g;
          if (x < W) {
            float2 v = make_float2(acc[m][4 * i + 2 * h] + bi.x,
                                   acc[m][4 * i + 2 * h + 1] + bi.y);
            if (!INPUT_GRAD) {
              v.x = fmaxf(v.x, 0.f);
              v.y = fmaxf(v.y, 0.f);
            }
            *reinterpret_cast<float2*>(row + (size_t)x * C + co) = v;
          }
        }
      }
    }
    base = (base + ROWS) % HALO_ROWS;
    __syncthreads();  // every warp is done with the halo before the next fill
  }
  cp_async_wait_all();
}

// what cudaFuncSetAttribute has granted each kernel on each device
bool smem_allowed[2][64];
int sm_count[64];

template <bool INPUT_GRAD>
cudaError_t launch(const float* in, const float* relu_out, const float* wpack,
                   const float* bias, float* out, int N, int H, int W, void* stream) {
  if (N < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64) return cudaErrorInvalidDevice;
  auto kernel = decoder_conv_s1_kernel<INPUT_GRAD>;
  if (!smem_allowed[INPUT_GRAD][device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_BYTES);
    if (err != cudaSuccess) return err;
    smem_allowed[INPUT_GRAD][device] = true;
  }
  if (sm_count[device] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  const long long tiles =
      (long long)N * ((H + ROWS - 1) / ROWS) * ((W + COLS - 1) / COLS);
  if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  const int grid = (int)(tiles < sm_count[device] ? tiles : sm_count[device]);
  kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      in, relu_out, reinterpret_cast<const float4*>(wpack), bias, out, N, H, W);
  return cudaGetLastError();
}

}  // namespace

// y = relu(conv_transpose2d(x, W, b, stride 1, padding 2)); x, y [N, H, W, 64];
// wpack: the forward's packed weight, [25, 8, 2, 8, 2, 8, 4]; bias [64].
extern "C" int decoder_conv_s1_forward_f32(const float* x, const float* wpack,
                                           const float* bias, float* y, int N, int H,
                                           int W, void* stream) {
  return (int)launch<false>(x, nullptr, wpack, bias, y, N, H, W, stream);
}

// dx = conv2d(g * [y > 0], W, padding 2); g, y, dx [N, H, W, 64]; wpack: the
// input gradient's packed weight.
extern "C" int decoder_conv_s1_input_grad_f32(const float* g, const float* y,
                                              const float* wpack, float* dx, int N, int H,
                                              int W, void* stream) {
  return (int)launch<true>(g, y, wpack, nullptr, dx, N, H, W, stream);
}

extern "C" const char* decoder_conv_s1_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
