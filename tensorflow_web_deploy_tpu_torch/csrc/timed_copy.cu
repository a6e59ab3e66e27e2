// A host-to-device copy between two timing events on one stream, the three
// enqueued by one call.
//
// Not a kernel: the engine's H2D on a replica's copy stream. From Python,
// event record, copy and event record are three calls, and torch lets the
// interpreter lock go inside each; the launch thread then waits to take it
// back (behind the HTTP workers) between the start event and the copy and
// between the copy and the end event. On an idle copy stream each event
// completes when it is enqueued, so the pair bracketed those waits too:
// 1.6-2.1 ms a batch against the profiler's 0.28-0.30 ms for the copy (an
// H100 at ~50 GB/s). Here the three are enqueued back to back, so the pair
// brackets the copy alone; the caller holds the stream's copy lock, so no
// other thread's work falls between them.
//
// The events are the caller's torch timing events (already created: torch
// creates an event when it first records it); a later record replaces the
// earlier one for elapsed time, stream waits and queries alike.

#include <cuda_runtime.h>

extern "C" int twd_timed_copy(void* dst, const void* src, long long nbytes, cudaEvent_t start,
                              cudaEvent_t end, cudaStream_t stream, int device) {
  if (nbytes < 0 || dst == nullptr || src == nullptr || start == nullptr || end == nullptr)
    return (int)cudaErrorInvalidValue;
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);  // the stream's device, for the calls below
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaEventRecord(start, stream);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(dst, src, (size_t)nbytes, cudaMemcpyHostToDevice, stream);
  if (err == cudaSuccess) err = cudaEventRecord(end, stream);
  if (prev >= 0 && prev != device) cudaSetDevice(prev);
  return (int)err;
}
