// Paged decode attention for NVIDIA Hopper (sm_90a): the decode kernel.
//
// Replaces: src/repro/kernels/paged_attention.py, paged_attention_kernel /
// _paged_kernel (Pallas, TPU).  Same function: one query token per
// sequence attends over KV pages found through block_table[b, j], masked to
// lengths[b]; GQA with q viewed (Hkv, G, D); online softmax in f32 with
// scale 1/sqrt(D); pages past the length are never read; length 0 -> zeros.
// Layouts: q/o (B, Hq, D), k/v_pages (P, page, Hkv, D), block_table
// (B, per_seq) int32, lengths (B,) int32, all contiguous; bf16 or f32 data;
// D a multiple of 8 and at most 128; G = Hq / Hkv at most 16.
//
// What bounds it on an H100: decode attention does 2 FLOP per byte or
// less, so it is bandwidth-bound.  Each cached token costs
// Hkv * D * 2 B * 2 (K and V) = 4096 B per layer for qwen3-0.6b in bf16;
// the bound is the bytes of the live tokens over 3.35 TB/s.
//
// What this design does about it: it is the simple, exact first version.
// One CTA of 256 threads per (sequence, KV head) serves the G query heads
// of that group, so each K/V row is read from memory once for all G heads.
// The CTA walks the sequence in tiles of 64 tokens that span pages (each
// token's page looked up once per tile in the block table).  Memory latency
// is what such a loop pays, so every K and V load of a tile is issued
// before any of them is used: each warp holds 8 tokens' keys in registers
// for the score product, and each thread holds the values of its column
// for a share of the tile's tokens.  One warp per query head then updates
// the running max and sum, and each thread accumulates its column for all
// G heads in f32 registers; the token shares are summed once at the end.
// With B * Hkv CTAs (64 at 8 slots x 8 KV heads) half of the card's 132
// SMs idle; splitting the sequence across CTAs with a second reduction
// pass (flash-decoding), and overlapping one tile's loads with the last
// tile's arithmetic, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int TILE = 64;              // tokens per tile (two per lane in softmax)
constexpr int TPW = TILE / NWARP;     // tokens per warp in the score product
constexpr int DPL = 4;                // head-dim elements per lane: D <= 128
constexpr int MAX_G = 16;             // query heads per KV head
constexpr int VPT = 32;               // value rows per thread: TILE / (256/D)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Shared memory, in floats: qs [G][D], ps [G][TILE], m/l/alpha [G] each,
// red [THREADS/D][G][D] for the final sum over token parts; then the
// tile's row offsets in the page pool, rows [TILE] (64-bit).
__host__ __device__ inline size_t smem_floats(int G, int D) {
  const size_t n = size_t(G) * D + size_t(G) * TILE + 3 * size_t(G) +
                   size_t(THREADS / D) * G * D;
  return (n + 1) & ~size_t(1);  // keep rows 8-byte aligned
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ o,
                    int Hq, int Hkv, int D, int page, int per_seq,
                    float sm_scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int G = Hq / Hkv;
  const int R = THREADS / D;        // token parts in the value product
  float* qs = smem;                 // [G][D]     the group's queries
  float* ps = qs + G * D;           // [G][TILE]  scores, then probabilities
  float* m_s = ps + G * TILE;       // [G]        running max
  float* l_s = m_s + G;             // [G]        running sum
  float* a_s = l_s + G;             // [G]        this tile's rescale factor
  float* red = a_s + G;             // [R][G][D]  per-part accumulators
  size_t* rows = reinterpret_cast<size_t*>(smem + smem_floats(G, D));

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  // value product: thread (part, d) sums tokens part, part + R, ...
  const int part = tid / D;
  const int vd = tid % D;
  const bool v_live = part < R;

  int len = lengths[b];
  len = max(0, min(len, per_seq * page));
  const int* tbl = table + size_t(b) * per_seq;
  const size_t tok_stride = size_t(Hkv) * D;  // one token's row in the pool
  const T* kh = kp + size_t(hk) * D;
  const T* vh = vp + size_t(hk) * D;

  const T* qg = q + (size_t(b) * Hq + size_t(hk) * G) * D;
  for (int e = tid; e < G * D; e += THREADS) qs[e] = to_f32(qg[e]);
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  float acc[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) acc[g] = 0.f;

  for (int t0 = 0; t0 < len; t0 += TILE) {
    const int n_tok = min(TILE, len - t0);
    if (tid < TILE) {
      const int t = t0 + tid;
      rows[tid] = tid < n_tok ? size_t(tbl[t / page]) * page + t % page : 0;
    }
    __syncthreads();

    // issue every load of the tile before using any: keys for the score
    // product (warp w: tokens w, w + 8, ...) and values for this thread
    float kr[TPW][DPL];
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int tt = warp + NWARP * i;
      const T* row = kh + rows[tt] * tok_stride;
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        kr[i][c] = (tt < n_tok && d < D) ? to_f32(row[d]) : 0.f;
      }
    }
    float vr[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int tt = part + R * i;
      vr[i] = (v_live && tt < n_tok)
                  ? to_f32(vh[rows[tt] * tok_stride + vd]) : 0.f;
    }

    // scores
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int tt = warp + NWARP * i;
      for (int g = 0; g < G; ++g) {
        float part_s = 0.f;
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int d = lane + 32 * c;
          if (d < D) part_s = fmaf(qs[g * D + d], kr[i][c], part_s);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part_s += __shfl_xor_sync(0xffffffffu, part_s, off);
        if (lane == 0)
          ps[g * TILE + tt] = tt < n_tok ? part_s * sm_scale : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: one warp per query head, two tokens per lane
    for (int g = warp; g < G; g += NWARP) {
      const bool ok0 = lane < n_tok;
      const bool ok1 = lane + 32 < n_tok;
      const float s0 = ps[g * TILE + lane];
      const float s1 = ps[g * TILE + lane + 32];
      float mx = fmaxf(ok0 ? s0 : NEG_INF, ok1 ? s1 : NEG_INF);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float safe_m = m_new <= NEG_INF / 2 ? 0.f : m_new;
      const float alpha = m_prev <= NEG_INF / 2 ? 0.f : expf(m_prev - safe_m);
      const float p0 = ok0 ? expf(s0 - safe_m) : 0.f;
      const float p1 = ok1 ? expf(s1 - safe_m) : 0.f;
      float rs = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      ps[g * TILE + lane] = p0;
      ps[g * TILE + lane + 32] = p1;
      if (lane == 0) {
        l_s[g] = l_s[g] * alpha + rs;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // values: this thread's tokens for every query head of the group
    if (v_live) {
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
          const float* pg = ps + g * TILE;
          float a = acc[g] * a_s[g];
#pragma unroll
          for (int i = 0; i < VPT; ++i) {
            const int tt = part + R * i;
            if (tt < TILE) a = fmaf(pg[tt], vr[i], a);
          }
          acc[g] = a;
        }
      }
    }
    __syncthreads();  // ps, a_s and rows are rewritten by the next tile
  }

  if (v_live) {
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) red[(part * G + g) * D + vd] = acc[g];
  }
  __syncthreads();
  T* og = o + (size_t(b) * Hq + size_t(hk) * G) * D;
  for (int e = tid; e < G * D; e += THREADS) {
    const int g = e / D;
    float sum = 0.f;
    for (int r = 0; r < R; ++r) sum += red[r * G * D + e];
    store(&og[e], sum / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* table,
           const void* lengths, void* o, int B, int Hq, int Hkv, int D,
           int page, int per_seq, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(Hq / Hkv, D) +
                      sizeof(size_t) * TILE;
  // at most ~29 KB (G = 16, D = 128): no opt-in above 48 KB needed
  const dim3 grid(Hkv, B);
  paged_decode_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<T*>(o), Hq, Hkv, D, page,
      per_seq, 1.f / sqrtf(float(D)));
  return int(cudaGetLastError());
}

}  // namespace

// Plain C entry: dtype 0 = float32, 1 = bfloat16.  Returns the CUDA error
// code of the launch (0 = launched).
extern "C" int repro_paged_attention(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const void* block_table,
                                     const void* lengths, void* o, int B,
                                     int Hq, int Hkv, int D, int page,
                                     int per_seq, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, block_table, lengths,
                                 o, B, Hq, Hkv, D, page, per_seq, s);
  return launch<float>(q, k_pages, v_pages, block_table, lengths, o, B, Hq,
                       Hkv, D, page, per_seq, s);
}
