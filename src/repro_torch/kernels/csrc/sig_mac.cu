// Endorsement MAC: Carter-Wegman polynomial MAC over GF(2^31 - 1).
//
// Replaces the Pallas kernel src/repro/kernels/sig_mac/kernel.py:mac_many
// (_mac_kernel). For each (transaction, endorser key) pair:
//   tag = s + sum_i mod31(m_i) * r^(W-i)  (mod p),  p = 2^31 - 1,
// evaluated by Horner's rule. The TPU kernel assembles each 32x32 product
// from 16-bit limbs because the TPU has no 64-bit integer unit; Hopper
// multiplies 32 x 32 -> 64 bits, so each step is one multiply-add and two
// Mersenne folds (x & p) + (x >> 31) (see Arithmetic below). Tags are
// canonical residues, so they are bit-equal to the limb form for keys in
// [0, p).
//
// Schedule. `step` is the number of rows a step:
// - step >= b: one step, one thread per (row, key) pair over as many thread
//   blocks as that takes (the whole block at once, P-II; the endorsers).
// - step < b: ONE thread block walks ceil(b / step) steps in row order,
//   with a __syncthreads() between steps; each step's step * NE Horner
//   chains run on its threads, looping where there are more than
//   blockDim. This is the reference's lax.scan over transactions or tiles
//   (Fabric 1.2's serial endorsement check and admission): B dependent
//   steps on the device in one launch, where one launch a transaction paid
//   the host's launch path B times. The block first copies a tile of rows
//   (up to 32 KB, whole steps) into shared memory with coalesced loads, so
//   a step's chains do not wait on device memory word by word.
//
// Arithmetic: inside the chain the accumulator is a lazy residue below
// 2^32: acc * r + m < 2^63 + 2^32 is one 32 x 32 -> 64-bit multiply-add,
// and two Mersenne folds bring it below 2^31 + 4; only the tag is reduced
// to its canonical residue. Congruent at every step, so the tags are the
// same bits as the canonical form.
//
// Bound: on the main path (verify: 100 tx x 22 words x 3 keys) the kernel
// reads about 10 KB, a few nanoseconds of HBM time; a whole-block call is
// bound by the launch. An ordered call adds its steps: each is a W-long
// chain of dependent multiply-folds plus a barrier, so its time grows with
// b / step as the reference's scan does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t kP = (1ull << 31) - 1;
constexpr int kThreads = 128;  // whole-block grid
constexpr int kMaxStepThreads = 1024;  // the ordered schedule's one block
constexpr int kTileWords = 8192;  // message words staged at a time

// x < 2^63 -> canonical residue in [0, p).
__device__ __forceinline__ uint64_t reduce(uint64_t x) {
  x = (x & kP) + (x >> 31);
  x = (x & kP) + (x >> 31);
  x = (x & kP) + (x >> 31);
  return x == kP ? 0 : x;
}

// x < 2^63 + 2^32 -> a residue congruent to x, below 2^31 + 4.
__device__ __forceinline__ uint32_t fold2(uint64_t x) {
  x = (x & kP) + (x >> 31);  // < 2^33
  return static_cast<uint32_t>((x & kP) + (x >> 31));
}

// tile_rows: rows staged in shared memory at a time (a multiple of step),
// or 0 to read the rows from device memory (the whole-block grid).
__global__ void mac_kernel(const uint32_t* __restrict__ msg,
                           const uint32_t* __restrict__ rs,
                           const uint32_t* __restrict__ ss,
                           uint32_t* __restrict__ tags, int b, int w, int ne,
                           int step, int tile_rows) {
  extern __shared__ uint32_t s_msg[];
  const int stride = gridDim.x * blockDim.x;
  const int tile = tile_rows ? tile_rows : b;
  // Every thread runs every step (the bounds are uniform), so each barrier
  // is reached by the whole block and no thread starts step s+1 early.
  for (int t0 = 0; t0 < b; t0 += tile) {
    const int t_end = min(b, t0 + tile);
    if (tile_rows) {
      const uint32_t* src = msg + static_cast<size_t>(t0) * w;
      for (int x = threadIdx.x; x < (t_end - t0) * w; x += blockDim.x)
        s_msg[x] = src[x];
      __syncthreads();
    }
    for (int row0 = t0; row0 < t_end; row0 += step) {
      const int n = min(step, b - row0) * ne;
      for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n;
           idx += stride) {
        const int tx = row0 + idx / ne;
        const int e = idx % ne;
        const uint32_t r = rs[e];
        const uint32_t* m =
            tile_rows ? s_msg + static_cast<size_t>(tx - t0) * w
                      : msg + static_cast<size_t>(tx) * w;
        uint32_t acc = 0;
        // Unrolled so that the next words' loads issue ahead of the chain.
#pragma unroll 4
        for (int i = 0; i < w; ++i)
          acc = fold2(static_cast<uint64_t>(acc) * r + m[i]);
        tags[static_cast<size_t>(tx) * ne + e] =
            static_cast<uint32_t>(reduce(static_cast<uint64_t>(acc) + ss[e]));
      }
      if (row0 + step < b) __syncthreads();  // one block when step < b
    }
  }
}

}  // namespace

extern "C" int mac_many(const uint32_t* msg, const uint32_t* rs,
                        const uint32_t* ss, uint32_t* tags, int b, int w,
                        int ne, int step, cudaStream_t stream) {
  if (step <= 0 || step >= b) {
    const int n = b * ne;
    mac_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        msg, rs, ss, tags, b, w, ne, b, 0);
  } else {
    const int per_step = ((step * ne + 31) / 32) * 32;
    const int threads = per_step < kMaxStepThreads ? per_step
                                                   : kMaxStepThreads;
    // Whole steps of rows a tile; none when one step's rows exceed it.
    int tile_rows = w > 0 ? kTileWords / w / step * step : 0;
    if (tile_rows > b) tile_rows = (b + step - 1) / step * step;
    const size_t smem = static_cast<size_t>(tile_rows) * w * sizeof(uint32_t);
    mac_kernel<<<1, threads, smem, stream>>>(msg, rs, ss, tags, b, w, ne, step,
                                             tile_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
