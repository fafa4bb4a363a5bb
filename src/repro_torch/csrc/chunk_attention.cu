// Chunk-prefill attention for Hopper: one slot's bucket-padded prompt chunk
// attends its resident KV prefix, read through the slot's block table from
// the paged pool, and then its own fresh K/V.
//
// Replaces src/repro/kernels/chunk_attention.py::_chunk_attn_kernel (the
// Pallas TPU kernel behind repro.kernels.chunk_attention, launched by
// _chunk_attention_call).  Same function: query row w of the W-row chunk
// sits at absolute position offset + w and attends (a) the prefix keys
// t < offset at k/v_pool[table_row[t / bs], t % bs, kh], a sentinel entry
// (n_blocks) masked and never dereferenced, then (b) the chunk keys
// k/v_chunk[j, kh] with j <= w and j < n_valid; fp32 scores, fp32 online
// softmax, fp32 accumulation; out (W, H, hd) in q's dtype through
// acc / max(l, 1e-30).  Rows w >= n_valid (padding) carry no contract but
// come out finite: they attend the prefix and the valid chunk keys before
// them, or nothing, which gives zeros.
//
// What bounds it.  Each resident prefix row and each chunk row of K/V is
// needed once per KV head, and each costs 4 * hd fp32 operations per query
// row of that head: with R = W * group query rows per KV head that is
// R / 2 operations per byte of an fp32 pool (R / 1 for bf16).  The card
// does about 20 fp32 operations per byte of HBM bandwidth (67 TFLOP/s over
// 3.35 TB/s), so a chunk of W * group <= ~40 rows is bound by bytes and
// wider ones (W = 8, 16, 32 at group 8) by fp32 operations.  Either way
// the least time at the serving shapes (at most 256 prefix rows and 32
// chunk rows, under 1 MB and ~75 MFLOP per launch) is about a microsecond,
// so a launch costs about its launch latency.
//
// Design.  The TPU grid (KV head, table entry + 1) is sequential and
// carries the softmax state in VMEM from the prefix steps into the chunk
// step.  Here one block per (tile of 16 of the W * group query rows of a KV
// head, KV head) runs both halves as loops inside the block: query row
// r = w * group + g maps to chunk position r / group.  The first loop
// streams the prefix positions below min(offset, max_table * bs) in tiles
// of 32 through shared memory (blocks at or past the offset are never
// visited); the second streams the chunk's valid keys, and skips tiles past
// the block's last chunk position.  offset and n_valid arrive as kernel
// arguments (host integers in the engine).  Blocks of one KV head each
// re-read the prefix, from L2 after the first.  The few blocks (2 to 32 at
// the smoke's shapes) leave most SMs idle; that is later work.

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int QR = 16;  // query rows per block

template <typename TQ, typename TP>
__global__ void __launch_bounds__(NT)
chunk_attention_kernel(const TQ* __restrict__ q, const TP* __restrict__ k_pool,
                       const TP* __restrict__ v_pool,
                       const int* __restrict__ table_row,
                       const TP* __restrict__ k_chunk,
                       const TP* __restrict__ v_chunk, TQ* __restrict__ out,
                       int W, int H, int kvh, int hd, int bs, int n_blocks,
                       int max_table, int offset, int n_valid) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kh = blockIdx.y;
  const int group = H / kvh;
  const int r0 = blockIdx.x * QR;
  const int rows = min(QR, W * group - r0);
  const Smem s = carve(smem_raw, QR, hd);

  // query row r0 + r is q[w, kh * group + g, :] with w * group + g = r0 + r
  for (int i = threadIdx.x; i < rows * hd; i += NT) {
    const int r = r0 + i / hd, d = i % hd;
    const int w = r / group, g = r - w * group;
    s.q[i] = to_f32(q[((size_t)w * H + (size_t)kh * group + g) * hd + d]);
  }
  init_rows(s, rows, hd);
  const float scale = rsqrtf(static_cast<float>(hd));
  __syncthreads();

  // (a) the resident prefix, strictly below the chunk: no per-row mask
  const long long cap = (long long)max_table * bs;
  const int n_prefix =
      offset <= 0 ? 0 : static_cast<int>(offset < cap ? offset : cap);
  for (int t0 = 0; t0 < n_prefix; t0 += KT) {
    const unsigned loaded = load_tile(
        s, k_pool, v_pool, hd, [&](int j) -> long long {
          const int t = t0 + j;
          if (t >= n_prefix) return -1;
          const int bid = table_row[t / bs];
          if (bid == n_blocks) return -1;
          const int blk = min(max(bid, 0), n_blocks - 1);
          return (((long long)blk * bs + t % bs) * kvh + kh) * hd;
        });
    if (loaded != 0u) {
      fold_tile(s, rows, hd, scale, loaded, false, 0, r0, group);
    }
    __syncthreads();
  }

  // (b) the chunk's own keys j < n_valid, causal in the chunk: j <= r / group
  const int n_chunk = max(0, min(n_valid, W));
  const int last_w = (r0 + rows - 1) / group;
  const int n_seen = min(n_chunk, last_w + 1);
  for (int j0 = 0; j0 < n_seen; j0 += KT) {
    const unsigned loaded = load_tile(
        s, k_chunk, v_chunk, hd, [&](int j) -> long long {
          const int c = j0 + j;
          if (c >= n_seen) return -1;
          return ((long long)c * kvh + kh) * hd;
        });
    if (loaded != 0u) {
      fold_tile(s, rows, hd, scale, loaded, true, j0, r0, group);
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < rows * hd; i += NT) {
    const int rr = i / hd, d = i % hd;
    const int r = r0 + rr;
    const int w = r / group, g = r - w * group;
    out[((size_t)w * H + (size_t)kh * group + g) * hd + d] =
        from_f32<TQ>(s.acc[i] / fmaxf(s.l[rr], 1e-30f));
  }
}

template <typename TQ, typename TP>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* table_row, const void* k_chunk, const void* v_chunk,
           void* out, int W, int H, int kvh, int hd, int bs, int n_blocks,
           int max_table, int offset, int n_valid, cudaStream_t stream) {
  const size_t smem = smem_bytes(QR, hd);
  auto kernel = chunk_attention_kernel<TQ, TP>;
  static std::atomic<size_t> allowed[MAX_DEVICES];  // per device
  cudaError_t err = allow_smem(kernel, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_rows = W * (H / kvh);
  kernel<<<dim3((n_rows + QR - 1) / QR, kvh), NT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(k_pool),
      static_cast<const TP*>(v_pool), table_row,
      static_cast<const TP*>(k_chunk), static_cast<const TP*>(v_chunk),
      static_cast<TQ*>(out), W, H, kvh, hd, bs, n_blocks, max_table, offset,
      n_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_dtype, pool_dtype: 0 = float32, 1 = bfloat16.  q (W, H, hd) and out
// (W, H, hd) in q's dtype, hd <= MAX_HD; k/v_pool (n_blocks, bs, kvh, hd)
// and k/v_chunk (W, kvh, hd) in the pool's dtype; table_row (max_table,)
// int32; all contiguous on the current device.  The launch goes on
// `stream`.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int chunk_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const void* table_row,
                                      const void* k_chunk,
                                      const void* v_chunk, void* out, int W,
                                      int H, int kvh, int hd, int bs,
                                      int n_blocks, int max_table, int offset,
                                      int n_valid, int q_dtype,
                                      int pool_dtype, void* stream) {
  if (W < 1 || kvh < 1 || H < kvh || H % kvh != 0 || hd < 1 ||
      hd > MAX_HD || bs < 1 || n_blocks < 1 || max_table < 1 ||
      kvh > 65535 || q_dtype < 0 || q_dtype > 1 || pool_dtype < 0 ||
      pool_dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* t = static_cast<const int*>(table_row);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype * 2 + pool_dtype) {
    case 0:
      return launch<float, float>(q, k_pool, v_pool, t, k_chunk, v_chunk, out,
                                  W, H, kvh, hd, bs, n_blocks, max_table,
                                  offset, n_valid, s);
    case 1:
      return launch<float, __nv_bfloat16>(q, k_pool, v_pool, t, k_chunk,
                                          v_chunk, out, W, H, kvh, hd, bs,
                                          n_blocks, max_table, offset,
                                          n_valid, s);
    case 2:
      return launch<__nv_bfloat16, float>(q, k_pool, v_pool, t, k_chunk,
                                          v_chunk, out, W, H, kvh, hd, bs,
                                          n_blocks, max_table, offset,
                                          n_valid, s);
    default:
      return launch<__nv_bfloat16, __nv_bfloat16>(
          q, k_pool, v_pool, t, k_chunk, v_chunk, out, W, H, kvh, hd, bs,
          n_blocks, max_table, offset, n_valid, s);
  }
}

extern "C" const char* chunk_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
