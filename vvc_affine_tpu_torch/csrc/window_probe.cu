// Window probes: a dynamic (row, lane) window read from an on-chip copy of a
// tile, at an offset known only when the kernel runs.
//
// Replaces the six TPU Pallas probe kernels of tools/mosaic_probe.py (built
// in `main`, launched through the one `pl.pallas_call` site of `run`):
// k_a (:59), k_b (:63), k_c (:69), k_e (:74), k_d_rows (:78) and
// k_d_lanes (:82).  Each reads x int16 [176, 256] and an int32 offset s and
// writes out int32 [8, 128]:
//
//   k_a        out = x[8s : 8s+8, 0:128]                          0 <= s <= 21
//   k_b        out[i, j] = x[(i - s) mod 48, j]   (jnp.roll of rows 0:48)
//   k_c        out[i, j] = x[i, (j - s) mod 256]  (jnp.roll of rows 0:8)
//   k_d_rows   out = x[c : c+8, 0:128],   c = clamp(start(s, 48), 0, 40)
//   k_d_lanes  out = x[0:8, c : c+128],   c = clamp(start(s, 256), 0, 128)
//   k_e        out = x[0:8, s : s+128]                             0 <= s <= 128
//
// where start(s, n) is s + n for s < 0, else s (lax.dynamic_slice counts a
// negative start from the end, then clamps).  The same function in plain
// PyTorch is vvc_affine_tpu_torch/tools/mosaic_probe.py `probe_plain`; its
// wrapper `probe` refuses the k_a and k_e offsets outside the ranges above,
// which the TPU kernels leave undefined.
//
// What bounds it on an H100: the launch.  A call needs 2 KB of window in and
// 4 KB out, about 2 ns at 3.35 TB/s; a launch takes microseconds.
//
// What the design does about it: nothing beyond being one small block.  One
// block of 256 threads stages the static region that the TPU kernel loads
// (rows 0:48 x lanes 0:128 for k_b and k_d_rows; rows 0:8 x lanes 0:256 for
// k_c, k_d_lanes and k_e; rows 8s:8s+8 x lanes 0:128 for k_a) into shared
// memory with 4-byte loads, synchronises, and each thread writes four
// outputs read from shared memory at the dynamic offset, with the wrap-around
// or the clamp above.  This is the Hopper counterpart of a dynamic window into
// a VMEM-resident tile: the read a warp kernel makes once each CTU's union
// window sits in shared memory.
//
// `vvc_empty_launch` launches an empty kernel of the same shape: the floor
// that every probe's time sits on.

#include <cuda_runtime.h>

namespace {

constexpr int W = 256;                       // x: [176, W]
constexpr int OH = 8, OW = 128;              // out
constexpr int ROLL_ROWS = 48;                // k_b / k_d_rows load rows 0:48
constexpr int THREADS = 256;

enum Probe { K_A, K_B, K_C, K_D_ROWS, K_D_LANES, K_E };

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int wrap(int v, int n) {
  const int m = v % n;
  return m < 0 ? m + n : m;
}

template <int PROBE>
__global__ void __launch_bounds__(THREADS)
probe_kernel(int* __restrict__ out, const short* __restrict__ x, int s) {
  // the staged region: RH rows from r0, lanes 0:RW
  constexpr int RH = (PROBE == K_B || PROBE == K_D_ROWS) ? ROLL_ROWS : OH;
  constexpr int RW = (PROBE == K_C || PROBE == K_D_LANES || PROBE == K_E)
                         ? W : OW;
  __shared__ __align__(16) short tile[RH * RW];

  const int r0 = PROBE == K_A ? 8 * s : 0;
  const int* src = reinterpret_cast<const int*>(x);
  int* dst = reinterpret_cast<int*>(tile);
  for (int k = threadIdx.x; k < RH * RW / 2; k += THREADS) {
    const int r = k / (RW / 2), c = k % (RW / 2);
    dst[k] = src[(r0 + r) * (W / 2) + c];
  }
  __syncthreads();

  // the dynamic offset, folded once: a shift for the rolls, a start for the
  // slices
  int off = 0;
  if constexpr (PROBE == K_B) off = wrap(s, ROLL_ROWS);
  if constexpr (PROBE == K_C) off = wrap(s, W);
  if constexpr (PROBE == K_D_ROWS)
    off = clampi(s < 0 ? s + ROLL_ROWS : s, 0, ROLL_ROWS - OH);
  if constexpr (PROBE == K_D_LANES) off = clampi(s < 0 ? s + W : s, 0, W - OW);
  if constexpr (PROBE == K_E) off = s;

  for (int k = threadIdx.x; k < OH * OW; k += THREADS) {
    const int i = k / OW, j = k % OW;
    int r = i, c = j;
    if constexpr (PROBE == K_B) r = (i - off + ROLL_ROWS) % ROLL_ROWS;
    if constexpr (PROBE == K_D_ROWS) r = i + off;
    if constexpr (PROBE == K_C) c = (j - off + W) % W;
    if constexpr (PROBE == K_D_LANES || PROBE == K_E) c = j + off;
    out[k] = tile[r * RW + c];
  }
}

__global__ void empty_kernel() {}

template <int PROBE>
int launch(void* out, const void* x, int s, void* stream) {
  probe_kernel<PROBE><<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), static_cast<const short*>(x), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out: int32 [8, 128]; x: int16 [176, 256], both contiguous on the device.
// Each launches one block on `stream` and returns cudaGetLastError().
extern "C" int vvc_probe_k_a(void* out, const void* x, int s, void* stream) {
  return launch<K_A>(out, x, s, stream);
}
extern "C" int vvc_probe_k_b(void* out, const void* x, int s, void* stream) {
  return launch<K_B>(out, x, s, stream);
}
extern "C" int vvc_probe_k_c(void* out, const void* x, int s, void* stream) {
  return launch<K_C>(out, x, s, stream);
}
extern "C" int vvc_probe_k_d_rows(void* out, const void* x, int s,
                                  void* stream) {
  return launch<K_D_ROWS>(out, x, s, stream);
}
extern "C" int vvc_probe_k_d_lanes(void* out, const void* x, int s,
                                   void* stream) {
  return launch<K_D_LANES>(out, x, s, stream);
}
extern "C" int vvc_probe_k_e(void* out, const void* x, int s, void* stream) {
  return launch<K_E>(out, x, s, stream);
}

extern "C" int vvc_empty_launch(void* stream) {
  empty_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
