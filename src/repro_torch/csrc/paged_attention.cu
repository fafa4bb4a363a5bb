// Paged-attention decode for Hopper: single-query GQA attention read
// straight from the paged KV pool through each slot's block table.
//
// Replaces src/repro/kernels/paged_attention.py::_paged_attn_kernel (the
// Pallas TPU kernel behind repro.kernels.paged_attention, launched by
// _paged_attention_call).  Same function: q (B, H, hd) attends the pool
// rows k/v_pool[table[b, t / bs], t % bs, kh] for key positions
// t <= pos[b]; a table entry equal to n_blocks (the sentinel) is never
// dereferenced and its keys are masked; fp32 scores, fp32 online softmax,
// fp32 accumulation; out (B, H, hd) in q's dtype, acc / max(l, 1e-30), so a
// slot with no key (all-sentinel table) emits zeros.
//
// What bounds it.  Per (slot, KV head) it reads each resident K/V row once
// and does 4 * group * hd operations per key row of 2 * hd elements: about
// 2 * group / sizeof(pool element) operations per byte (4 at group 8 with
// an fp32 pool), far below the card's FP32 rate per byte of HBM
// bandwidth.  It is bound by bytes: at the serving shapes a layer's decode
// reads at most a few MB, so a launch costs about its launch latency.
//
// Design.  The TPU grid (slot, KV head, table entry) is sequential and
// carries the softmax state across table entries in VMEM.  Here one block
// per (KV head, slot) loops over the key positions itself: it reads pos[b]
// and the table row from device memory (no host synchronisation), stops at
// min(pos[b] + 1, max_table * bs) (entries past pos are skipped, which is
// what the TPU kernel's mask does to them; a slot frozen at
// pos == max_table * bs reads the whole table and nothing past it), and
// streams the keys in tiles of 32 through shared memory in fp32
// (attention_common.cuh).  The group = H / kvh query rows of the KV head
// stay in shared memory for the whole loop and the output is written once.
// B * kvh blocks (16 at the smoke's decode shape) leave most of the 132
// SMs idle; splitting the key range across blocks (flash-decoding) is
// later work.

#include "attention_common.cuh"

namespace {

using namespace attn;

template <typename TQ, typename TP>
__global__ void __launch_bounds__(NT)
paged_attention_kernel(const TQ* __restrict__ q, const TP* __restrict__ k_pool,
                       const TP* __restrict__ v_pool,
                       const int* __restrict__ table,
                       const int* __restrict__ pos, TQ* __restrict__ out,
                       int H, int kvh, int hd, int bs, int n_blocks,
                       int max_table) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kh = blockIdx.x, b = blockIdx.y;
  const int group = H / kvh;
  const Smem s = carve(smem_raw, group, hd);

  // this KV head's query rows q[b, kh * group + g, :] are contiguous
  const size_t row0 = ((size_t)b * H + (size_t)kh * group) * hd;
  for (int i = threadIdx.x; i < group * hd; i += NT) {
    s.q[i] = to_f32(q[row0 + i]);
  }
  init_rows(s, group, hd);

  const long long p = pos[b];
  const long long cap = (long long)max_table * bs;
  const int n_keys = p < 0 ? 0 : static_cast<int>(p + 1 < cap ? p + 1 : cap);
  const int* trow = table + (size_t)b * max_table;
  const float scale = 1.f / sqrtf(static_cast<float>(hd));
  __syncthreads();

  for (int t0 = 0; t0 < n_keys; t0 += KT) {
    const unsigned loaded = load_tile(
        s, k_pool, v_pool, hd, [&](int j) -> long long {
          const int t = t0 + j;
          if (t >= n_keys) return -1;
          const int bid = trow[t / bs];
          if (bid == n_blocks) return -1;
          const int blk = min(max(bid, 0), n_blocks - 1);
          return (((long long)blk * bs + t % bs) * kvh + kh) * hd;
        });
    if (loaded != 0u) {
      fold_tile(s, group, hd, scale, loaded, false, 0, 0, 1);
    }
    __syncthreads();  // the next tile overwrites K/V
  }

  for (int i = threadIdx.x; i < group * hd; i += NT) {
    const int r = i / hd;
    out[row0 + i] = from_f32<TQ>(s.acc[i] / fmaxf(s.l[r], 1e-30f));
  }
}

template <typename TQ, typename TP>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* table, const int* pos, void* out, int B, int H, int kvh,
           int hd, int bs, int n_blocks, int max_table, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / kvh, hd);
  auto kernel = paged_attention_kernel<TQ, TP>;
  static std::atomic<size_t> allowed[MAX_DEVICES];  // per device
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(kvh, B), NT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(k_pool),
      static_cast<const TP*>(v_pool), table, pos, static_cast<TQ*>(out), H,
      kvh, hd, bs, n_blocks, max_table);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_dtype, pool_dtype: 0 = float32, 1 = bfloat16.  q (B, H, hd), k/v_pool
// (n_blocks, bs, kvh, hd), table (B, max_table) int32, pos (B,) int32 and
// out (B, H, hd) in q's dtype, hd <= MAX_HD, are contiguous on the current
// device; the launch goes on `stream`.  Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* table,
                                      const void* pos, void* out, int B, int H,
                                      int kvh, int hd, int bs, int n_blocks,
                                      int max_table, int q_dtype,
                                      int pool_dtype, void* stream) {
  if (B < 1 || kvh < 1 || H < kvh || H % kvh != 0 || hd < 1 ||
      hd > MAX_HD || bs < 1 || n_blocks < 1 || max_table < 1 || B > 65535 ||
      q_dtype < 0 || q_dtype > 1 || pool_dtype < 0 || pool_dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* t = static_cast<const int*>(table);
  const int* p = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype * 2 + pool_dtype) {
    case 0:
      return launch<float, float>(q, k_pool, v_pool, t, p, out, B, H, kvh, hd,
                                  bs, n_blocks, max_table, s);
    case 1:
      return launch<float, __nv_bfloat16>(q, k_pool, v_pool, t, p, out, B, H,
                                          kvh, hd, bs, n_blocks, max_table, s);
    case 2:
      return launch<__nv_bfloat16, float>(q, k_pool, v_pool, t, p, out, B, H,
                                          kvh, hd, bs, n_blocks, max_table, s);
    default:
      return launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, t, p,
                                                  out, B, H, kvh, hd, bs,
                                                  n_blocks, max_table, s);
  }
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
