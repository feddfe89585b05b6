// A timestamp on the card's own clock, written from inside a stream.
//
// One thread reads %globaltimer (nanoseconds, one clock for every SM; clock64
// counts cycles of one SM) and stores it in slots[slot]. Launched between two
// stages of a stream, or captured between two nodes of a CUDA graph, it
// marks where the first stage ended on the card: the difference of two
// stamps is the device time of the work enqueued between them.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(int64_t* slots, int slot) {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  slots[slot] = static_cast<int64_t>(t);
}

}  // namespace

// slots: int64 device buffer with more than `slot` entries. One launch of
// one thread on `stream`. Returns the launch's cudaError_t.
extern "C" int stamp_launch(int64_t* slots, int slot, void* stream) {
  if (slot < 0) return (int)cudaErrorInvalidValue;
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(slots, slot);
  return (int)cudaGetLastError();
}
