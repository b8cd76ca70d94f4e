// Empty kernels that mark where a span of the program (repro_torch.spans)
// starts and ends in a profiler's trace of the card.  A mark is numbered in
// the order the host launched it and runs as span_mark<number mod
// SPAN_MARKS>, so each mark in a trace names its number but for a multiple
// of SPAN_MARKS: a trace that lost marks at either end, or holds a few out
// of their order, can still be paired with the marks the host launched.
//
// Plain C interface (loaded with ctypes); not a kernel of any path, so not
// named *_launch.

#include <cuda_runtime.h>

#define SPAN_MARKS 16

namespace spans {

template <int K>
__global__ void span_mark() {}

}  // namespace spans

extern "C" {

// Launches the mark of class k (0 <= k < SPAN_MARKS) on stream; returns the
// cudaError_t of the launch (0 = launched).
int launch_span_mark(int k, void* stream) {
  using spans::span_mark;
  static void (*const kMarks[SPAN_MARKS])() = {
      span_mark<0>,  span_mark<1>,  span_mark<2>,  span_mark<3>,
      span_mark<4>,  span_mark<5>,  span_mark<6>,  span_mark<7>,
      span_mark<8>,  span_mark<9>,  span_mark<10>, span_mark<11>,
      span_mark<12>, span_mark<13>, span_mark<14>, span_mark<15>};
  if (k < 0 || k >= SPAN_MARKS) return (int)cudaErrorInvalidValue;
  return (int)cudaLaunchKernel((const void*)kMarks[k], dim3(1), dim3(1),
                               nullptr, 0, (cudaStream_t)stream);
}

}  // extern "C"
