// Shared body of the port's two paged-attention kernels
// (paged_attention.cu, chunk_attention.cu): an fp32 online softmax over
// tiles of 32 keys, for a block's query rows held in shared memory.
//
// A block of NT threads owns `rows` query rows of one KV head.  Shared
// memory holds the rows' fp32 queries, their running max m, running sum l
// and fp32 output accumulator, and one tile of KT keys: K rows (padded by
// one float, so that lane j reading K row j at column d hits bank (j + d))
// and V rows, both converted to fp32.  Warp w folds rows w, w + NW, ...:
// lane j scores key j of the tile, the warp reduces max and sum with
// shuffles, and each lane then updates the accumulator columns
// d = lane, lane + 32, ... (head_dim <= MAX_HD) from the V tile.
//
// Masking is by select and by skipping, never by arithmetic:
//  * load_tile() never reads a masked key (unmapped position, sentinel
//    block, past the frontier): its shared-memory row is zero and its bit is
//    clear in the tile's mask;
//  * fold_tile() scores only the keys whose bit is set (NEG_INF otherwise),
//    takes p = 0 by select for the others, and sums p * v over the set bits
//    only, so a masked key is never multiplied in;
//  * each kernel's final write divides by max(l, 1e-30): a row that saw no
//    key emits exact zeros, not NaN.

#pragma once

#include <atomic>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace attn {

constexpr float NEG_INF = -1e30f;  // equals repro_torch.nn.attention.NEG_INF
constexpr int KT = 32;             // keys per tile: one per lane
constexpr int NW = 8;              // warps per block
constexpr int NT = 32 * NW;        // threads per block
constexpr int LU = 8;              // K (and V) loads in flight per thread
constexpr int MAXD = 8;            // accumulator columns per lane
constexpr int MAX_HD = 32 * MAXD;  // the largest head_dim the kernels take
constexpr size_t DEFAULT_SMEM = 48 * 1024;
constexpr size_t MAX_SMEM = 227 * 1024;
constexpr int MAX_DEVICES = 64;  // devices whose smem limit is remembered

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The carve-up of the block's dynamic shared memory.
struct Smem {
  float* q;        // [rows][hd]
  float* acc;      // [rows][hd]
  float* m;        // [rows]
  float* l;        // [rows]
  float* k;        // [KT][hd + 1]
  float* v;        // [KT][hd]
  float* p;        // [NW][KT]  one warp's probabilities, for broadcast
  long long* off;  // [KT]      element offset of each key's row, -1 = masked
  unsigned* bits;  // [1]       the tile's mask of loaded keys
};

__host__ __device__ inline size_t smem_bytes(int rows, int hd) {
  const size_t floats = 2 * (size_t)rows * hd + 2 * (size_t)rows +
                        (size_t)KT * (hd + 1) + (size_t)KT * hd +
                        (size_t)NW * KT;
  return sizeof(long long) * KT + sizeof(float) * floats + sizeof(unsigned);
}

__device__ inline Smem carve(void* base, int rows, int hd) {
  Smem s;
  s.off = static_cast<long long*>(base);  // 8-byte aligned part first
  float* f = reinterpret_cast<float*>(s.off + KT);
  s.q = f;
  s.acc = s.q + (size_t)rows * hd;
  s.m = s.acc + (size_t)rows * hd;
  s.l = s.m + rows;
  s.k = s.l + rows;
  s.v = s.k + (size_t)KT * (hd + 1);
  s.p = s.v + (size_t)KT * hd;
  s.bits = reinterpret_cast<unsigned*>(s.p + NW * KT);
  return s;
}

// Zero the accumulators, m = NEG_INF, l = 0.
__device__ inline void init_rows(const Smem& s, int rows, int hd) {
  for (int i = threadIdx.x; i < rows * hd; i += NT) s.acc[i] = 0.f;
  for (int i = threadIdx.x; i < rows; i += NT) {
    s.m[i] = NEG_INF;
    s.l[i] = 0.f;
  }
}

// Load the tile's KT keys into shared memory in fp32.  `key_offset(j)`
// gives the element offset of key j's head_dim row in k_base / v_base, or
// -1 if the key is masked (it is then never read).  Returns the tile's
// mask of loaded keys, the same in every thread.  Ends synchronised.
template <typename TP, typename OffsetFn>
__device__ inline unsigned load_tile(const Smem& s,
                                     const TP* __restrict__ k_base,
                                     const TP* __restrict__ v_base, int hd,
                                     OffsetFn key_offset) {
  if (threadIdx.x < 32) {
    const long long o = key_offset(static_cast<int>(threadIdx.x));
    s.off[threadIdx.x] = o;
    const unsigned b = __ballot_sync(0xffffffffu, o >= 0);
    if (threadIdx.x == 0) *s.bits = b;
  }
  __syncthreads();
  // LU loads of K and of V in flight per thread before any is stored:
  // one round trip to device memory per LU elements, not per element
  const int ldk = hd + 1, n = KT * hd;
  for (int base = threadIdx.x; base < n; base += NT * LU) {
    float kv[LU], vv[LU];
#pragma unroll
    for (int u = 0; u < LU; ++u) {
      const int i = base + u * NT;
      kv[u] = 0.f;
      vv[u] = 0.f;
      if (i < n) {
        const int j = i / hd;
        const long long o = s.off[j];
        if (o >= 0) {
          kv[u] = to_f32(k_base[o + (i - j * hd)]);
          vv[u] = to_f32(v_base[o + (i - j * hd)]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < LU; ++u) {
      const int i = base + u * NT;
      if (i < n) {
        const int j = i / hd, d = i - j * hd;
        s.k[j * ldk + d] = kv[u];
        s.v[j * hd + d] = vv[u];
      }
    }
  }
  __syncthreads();
  return *s.bits;
}

// Fold the loaded tile into this warp's rows.  Key j of the tile is
// attended by row r iff bit j of `loaded` is set and, when `causal`, the
// key's chunk index kidx0 + j is <= the row's chunk position (r0 + r) /
// group.  All lanes of a warp take the same branches.
__device__ inline void fold_tile(const Smem& s, int rows, int hd, float scale,
                                 unsigned loaded, bool causal, int kidx0,
                                 int r0, int group) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ldk = hd + 1;
  float* pw = s.p + warp * KT;
  for (int r = warp; r < rows; r += NW) {
    unsigned valid = loaded;
    if (causal) {
      const int lim = (r0 + r) / group - kidx0;  // keys j <= lim
      valid &= lim >= 31 ? 0xffffffffu : (lim < 0 ? 0u : ((2u << lim) - 1u));
    }
    if (valid == 0u) continue;
    const bool mine = (valid >> lane) & 1u;
    float sc = NEG_INF;
    if (mine) {
      // four partial sums: four independent FMA chains, not one
      const float* qr = s.q + (size_t)r * hd;
      const float* kr = s.k + (size_t)lane * ldk;
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
      int d = 0;
      for (; d + 4 <= hd; d += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          dot[u] = fmaf(qr[d + u], kr[d + u], dot[u]);
        }
      }
      for (; d < hd; ++d) dot[0] = fmaf(qr[d], kr[d], dot[0]);
      sc = ((dot[0] + dot[1]) + (dot[2] + dot[3])) * scale;
    }
    const float m_prev = s.m[r];
    const float m_new = fmaxf(m_prev, warp_max(sc));
    const float p = mine ? expf(sc - m_new) : 0.f;
    const float corr = expf(m_prev - m_new);
    const float psum = warp_sum(p);
    pw[lane] = p;
    __syncwarp();
    // the lane's accumulator columns d = lane + 32 c in registers: MAXD
    // independent FMA chains; a masked key is skipped, never multiplied
    float* ar = s.acc + (size_t)r * hd;
    float a[MAXD];
#pragma unroll
    for (int c = 0; c < MAXD; ++c) {
      const int d = lane + 32 * c;
      a[c] = d < hd ? ar[d] * corr : 0.f;
    }
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if ((valid >> j) & 1u) {
        const float pj = pw[j];
        const float* vr = s.v + j * hd;
#pragma unroll
        for (int c = 0; c < MAXD; ++c) {
          const int d = lane + 32 * c;
          if (d < hd) a[c] = fmaf(pj, vr[d], a[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < MAXD; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) ar[d] = a[c];
    }
    if (lane == 0) {
      s.m[r] = m_new;
      s.l[r] = s.l[r] * corr + psum;
    }
    __syncwarp();
  }
}

// Raise a kernel's dynamic shared-memory limit when a launch needs more
// than the default 48 KB.  The attribute is per device, so `allowed` (one
// array per kernel instantiation, zero at start) holds the largest limit
// set so far on each device: a stream of launches at one size makes one
// cudaFuncSetAttribute call, not one per launch.  Returns the CUDA error
// code (0 = fine).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes,
                              std::atomic<size_t>* allowed) {
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  if (bytes <= DEFAULT_SMEM) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool cached = dev >= 0 && dev < MAX_DEVICES;
  if (cached && allowed[dev].load() >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && cached) {
    size_t cur = allowed[dev].load();
    while (cur < bytes && !allowed[dev].compare_exchange_weak(cur, bytes)) {
    }
  }
  return err;
}

}  // namespace attn
