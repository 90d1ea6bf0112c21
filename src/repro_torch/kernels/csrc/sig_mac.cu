// Endorsement MAC: Carter-Wegman polynomial MAC over GF(2^31 - 1).
//
// Replaces the Pallas kernel src/repro/kernels/sig_mac/kernel.py:mac_many
// (_mac_kernel). For each (transaction, endorser key) pair:
//   tag = s + sum_i mod31(m_i) * r^(W-i)  (mod p),  p = 2^31 - 1,
// evaluated by Horner's rule. The TPU kernel assembles each 32x32 product
// from 16-bit limbs because the TPU has no 64-bit integer unit; Hopper
// multiplies 64-bit integers, so each step is one 64-bit product and a
// Mersenne fold (x & p) + (x >> 31). Results are canonical residues, so they
// are bit-equal to the limb form for keys in [0, p).
//
// Bound: on the main path (verify: 100 tx x 22 words x 3 keys) the kernel
// reads about 10 KB, a few nanoseconds of HBM time; it is bound by launch
// latency. Design: one thread per (tx, key) pair, the W-step Horner chain
// in registers; the threads of one transaction read the same message words,
// which the L1 serves. No shared memory, no synchronisation.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t kP = (1ull << 31) - 1;

// x < 2^63 -> canonical residue in [0, p).
__device__ __forceinline__ uint64_t reduce(uint64_t x) {
  x = (x & kP) + (x >> 31);
  x = (x & kP) + (x >> 31);
  x = (x & kP) + (x >> 31);
  return x == kP ? 0 : x;
}

__global__ void mac_kernel(const uint32_t* __restrict__ msg,
                           const uint32_t* __restrict__ rs,
                           const uint32_t* __restrict__ ss,
                           uint32_t* __restrict__ tags, int b, int w, int ne) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= b * ne) return;
  int tx = idx / ne;
  int e = idx - tx * ne;
  const uint64_t r = rs[e];
  const uint32_t* m = msg + static_cast<size_t>(tx) * w;
  uint64_t acc = 0;
  for (int i = 0; i < w; ++i) acc = reduce(acc * r + reduce(m[i]));
  tags[idx] = static_cast<uint32_t>(reduce(acc + ss[e]));
}

}  // namespace

extern "C" int mac_many(const uint32_t* msg, const uint32_t* rs,
                        const uint32_t* ss, uint32_t* tags, int b, int w,
                        int ne, cudaStream_t stream) {
  const int threads = 128;
  const int n = b * ne;
  mac_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
      msg, rs, ss, tags, b, w, ne);
  return static_cast<int>(cudaGetLastError());
}
