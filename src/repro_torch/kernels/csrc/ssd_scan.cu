// Mamba2 SSD chunk scan for NVIDIA Hopper (sm_90a): the prefill kernel of
// the hybrid family's Mamba2 layers.
//
// Replaces: src/repro/kernels/ssd_scan.py, ssd_scan_kernel / _ssd_kernel
// (Pallas, TPU).  Same function, per (batch, head), over chunks of 128 steps
// walked in order with the state S (p x n) carried in f32:
//   cs     = cumsum(a) within the chunk, total = cs[last]
//   G[i,j] = (C_i . B_j) exp(cs_i - cs_j) for j <= i, else 0
//   y      = G x + exp(cs) (C S^T)
//   S'     = exp(total) S + x^T (B exp(total - cs))
// Beyond the TPU kernel, it starts from an initial state (or zeros) and
// returns the final state, which prefill-with-state needs.  Layouts are the
// model's own: x/y (b, l, h, p), a (b, l, h), B/C (b, l, n) shared by all
// heads (read by batch, never copied per head), init/final (b, h, p, n); all
// f32 and contiguous; p and n multiples of 4, at most 64.  A ragged last
// chunk is predicated: its missing steps read as a = 0, x = B = C = 0, so
// they leave the state unchanged, and their y rows are not stored.
//
// What bounds it on an H100: at zamba2-7b's largest prefill bucket (b = 1,
// l = 1024, h = 112, p = n = 64) the function needs ~2.8 GFLOP (C B^T once
// per batch and chunk, G x, C S^T and x^T B per head, lower triangles only),
// ~42 us at the 67 TFLOP/s f32 rate, against ~63 MB of inputs and outputs
// (~19 us at 3.35 TB/s): bound by operations.  All products are IEEE f32
// FMAs (no TF32), as the f32 state of the reference asks.
//
// What this design does about it: it is the simple, exact first version.
// One CTA of 256 threads per (head, batch), walking the chunks in order (the
// loop takes the place of the TPU's sequential grid axis); b * h = 112 CTAs
// fill one wave of the 132 SMs.  Per chunk, the x tile, C and B transposed,
// the 128 x 128 decay-weighted score matrix G (transposed) and the state
// stay in shared memory (~183 KB at p = n = 64); each phase is register
// blocked (G: only the lower-triangular 16-column groups are computed; y:
// 8 x 4 per thread, its j loop cut at the diagonal; S: 4 x 4 per thread).
// The decay is masked before exp, so exp never sees j > i.  It does not use
// the tensor cores, overlaps no load with arithmetic, and recomputes C B^T
// for every head of a batch: computing the chunk states in parallel, a
// short pass across chunks, and the outputs on the tensor cores is later
// work.

#include <cuda_runtime.h>

namespace {

constexpr int L = 128;        // steps per chunk
constexpr int SB = 16;        // block of the cumulative sum
constexpr int THREADS = 256;  // 16 x 16
constexpr int LDG = L + 4;    // pitch of Gt rows: float4-aligned
constexpr int LDT = L + 1;    // pitch of Ct/Bt rows: odd, so the transposed
                              // stores hit 32 banks

// Shared memory, in floats: Gt [L][LDG] (later Bw [L][N+4]), Xs [L][P+4],
// St [N][P+4], Ct [N][LDT], Bt [N][LDT], cs / ecs / w [L] each.
__host__ __device__ inline size_t smem_floats(int P, int N) {
  return size_t(L) * LDG + size_t(L) * (P + 4) + size_t(N) * (P + 4) +
         2 * size_t(N) * LDT + 3 * size_t(L);
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* __restrict__ init, float* __restrict__ y,
                float* __restrict__ final_state, int l, int H, int P,
                int N) {
  extern __shared__ float4 smem4[];
  const int PP = P + 4;
  const int NP = N + 4;
  float* Gt = reinterpret_cast<float*>(smem4);  // [L][LDG] G^T, then Bw
  float* Xs = Gt + L * LDG;                     // [L][PP]  x of the chunk
  float* St = Xs + L * PP;                      // [N][PP]  S^T, f32
  float* Ct = St + N * PP;                      // [N][LDT] C^T
  float* Bt = Ct + N * LDT;                     // [N][LDT] B^T
  float* cs = Bt + N * LDT;                     // [L] cumulative log-decay
  float* ecs = cs + L;                          // [L] exp(cs)
  float* wv = ecs + L;                          // [L] exp(total - cs)
  float* Bw = Gt;                               // [L][NP] B * w, after y

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const size_t xrow = size_t(H) * P;  // one step of x and y
  const float* xb = x + size_t(b) * l * xrow + size_t(h) * P;
  float* yb = y + size_t(b) * l * xrow + size_t(h) * P;
  const float* ab = a + size_t(b) * l * H + h;
  const float* Bb = Bm + size_t(b) * l * N;
  const float* Cb = Cm + size_t(b) * l * N;
  const size_t st_off = (size_t(b) * H + h) * P * N;

  for (int e = tid; e < P * N; e += THREADS) {
    const int p = e / N, k = e % N;
    St[k * PP + p] = init ? init[st_off + e] : 0.f;
  }

  for (int c0 = 0; c0 < l; c0 += L) {
    const int Lc = min(L, l - c0);
    __syncthreads();  // the last chunk's tiles are no longer read

    // ---- load the chunk: x row-major, C and B transposed ----
    for (int e = tid; e < L * P; e += THREADS) {
      const int t = e / P, p = e % P;
      Xs[t * PP + p] = t < Lc ? xb[size_t(c0 + t) * xrow + p] : 0.f;
    }
    for (int e = tid; e < L * N; e += THREADS) {
      const int t = e / N, k = e % N;
      const bool ok = t < Lc;
      const size_t g = size_t(c0 + t) * N + k;
      Ct[k * LDT + t] = ok ? Cb[g] : 0.f;
      Bt[k * LDT + t] = ok ? Bb[g] : 0.f;
    }
    // cumulative log-decay, its additions in the reference's order (XLA
    // sums a long cumsum in blocks of SB in sequence, then adds the running
    // sum of the block totals): exp(cs_i - cs_j) is a difference of two
    // sums that reach -1e3 within a chunk, so each rounding of cs shows in
    // y.  Missing steps add a = 0.
    if (tid < L / SB) {
      float run = 0.f;
      for (int i = 0; i < SB; ++i) {
        const int t = tid * SB + i;
        run += t < Lc ? ab[size_t(c0 + t) * H] : 0.f;
        cs[t] = run;
      }
    }
    __syncthreads();
    if (tid == 0) {  // exclusive running sum of the block totals, into ecs
      float excl = 0.f;
      for (int k = 0; k < L / SB; ++k) {
        ecs[k] = excl;
        excl += cs[k * SB + SB - 1];
      }
    }
    __syncthreads();
    for (int t = tid; t < L; t += THREADS) cs[t] += ecs[t / SB];
    __syncthreads();
    const float total = cs[L - 1];
    for (int t = tid; t < L; t += THREADS) {
      ecs[t] = expf(cs[t]);
      wv[t] = expf(total - cs[t]);
    }

    // ---- G^T: rows i = ty + 16 r, columns j = tx + 16 c; a pair (r, c)
    // with c > r has j > i everywhere, so only c <= r is computed ----
    {
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
      for (int k = 0; k < N; ++k) {
        float cv[8], bv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) cv[r] = Ct[k * LDT + ty + 16 * r];
#pragma unroll
        for (int c = 0; c < 8; ++c) bv[c] = Bt[k * LDT + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c <= r; ++c)
            acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = ty + 16 * r;
        const float cs_i = cs[i];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int j = tx + 16 * c;
          float g = 0.f;
          // mask before exp: exp(cs_i - cs_j) may overflow for j > i
          if (c <= r && j <= i) g = acc[r][c] * expf(cs_i - cs[j]);
          Gt[j * LDG + i] = g;
        }
      }
    }
    __syncthreads();

    // ---- y = G x + exp(cs) (C S^T): rows ty*8 .. +8, columns tx*4 .. +4;
    // G is zero past the diagonal, so j stops at the block's last row ----
    if (tx * 4 < P) {
      float acc[8][4], accs[8][4];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = accs[r][q] = 0.f;
      const int j_end = ty * 8 + 8;
      for (int j = 0; j < j_end; ++j) {
        const float4 g0 = *reinterpret_cast<const float4*>(&Gt[j * LDG + ty * 8]);
        const float4 g1 =
            *reinterpret_cast<const float4*>(&Gt[j * LDG + ty * 8 + 4]);
        const float4 xv = *reinterpret_cast<const float4*>(&Xs[j * PP + tx * 4]);
        const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        const float xq[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(gv[r], xq[q], acc[r][q]);
      }
      for (int k = 0; k < N; ++k) {
        float cv[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) cv[r] = Ct[k * LDT + ty * 8 + r];
        const float4 sv = *reinterpret_cast<const float4*>(&St[k * PP + tx * 4]);
        const float sq[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            accs[r][q] = fmaf(cv[r], sq[q], accs[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = ty * 8 + r;
        if (i < Lc) {
          const float e = ecs[i];
          float4 out;
          out.x = fmaf(e, accs[r][0], acc[r][0]);
          out.y = fmaf(e, accs[r][1], acc[r][1]);
          out.z = fmaf(e, accs[r][2], acc[r][2]);
          out.w = fmaf(e, accs[r][3], acc[r][3]);
          *reinterpret_cast<float4*>(&yb[size_t(c0 + i) * xrow + tx * 4]) =
              out;
        }
      }
    }
    __syncthreads();  // G^T and S are read; G's space takes B * w

    // ---- S' = exp(total) S + x^T (B * w): p = ty*4 .. +4, k = tx*4 .. +4
    for (int e = tid; e < L * N; e += THREADS) {
      const int j = e / N, k = e % N;
      Bw[j * NP + k] = Bt[k * LDT + j] * wv[j];
    }
    __syncthreads();
    if (ty * 4 < P && tx * 4 < N) {
      float acc[4][4];
#pragma unroll
      for (int pi = 0; pi < 4; ++pi)
#pragma unroll
        for (int ki = 0; ki < 4; ++ki) acc[pi][ki] = 0.f;
      for (int j = 0; j < Lc; ++j) {  // missing steps have x = 0
        const float4 xv = *reinterpret_cast<const float4*>(&Xs[j * PP + ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bw[j * NP + tx * 4]);
        const float xq[4] = {xv.x, xv.y, xv.z, xv.w};
        const float bq[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int pi = 0; pi < 4; ++pi)
#pragma unroll
          for (int ki = 0; ki < 4; ++ki)
            acc[pi][ki] = fmaf(xq[pi], bq[ki], acc[pi][ki]);
      }
      const float dec = expf(total);
#pragma unroll
      for (int ki = 0; ki < 4; ++ki)
#pragma unroll
        for (int pi = 0; pi < 4; ++pi) {
          float* s = &St[(tx * 4 + ki) * PP + ty * 4 + pi];
          *s = fmaf(dec, *s, acc[pi][ki]);
        }
    }
  }

  __syncthreads();
  for (int e = tid; e < P * N; e += THREADS) {
    const int p = e / N, k = e % N;
    final_state[st_off + e] = St[k * PP + p];
  }
}

}  // namespace

// Plain C entry.  init may be null (a zero initial state).  Returns the
// CUDA error code of the launch (0 = launched).
extern "C" int repro_ssd_scan(const void* x, const void* a, const void* B,
                              const void* C, const void* init, void* y,
                              void* final_state, int batch, int l, int H,
                              int P, int N, void* stream) {
  const size_t smem = sizeof(float) * smem_floats(P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(H, batch);
  ssd_scan_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(a),
      static_cast<const float*>(B), static_cast<const float*>(C),
      static_cast<const float*>(init), static_cast<float*>(y),
      static_cast<float*>(final_state), l, H, P, N);
  return int(cudaGetLastError());
}
