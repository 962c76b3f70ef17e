// Phase stamps of the training superstep, for Hopper (sm_90a): one thread
// writes the card's %globaltimer (ns) into a row of a small device ring at
// a phase boundary (repro_torch.obs.trace.stamp). It replaces no TPU
// kernel: the reference reads its phases from the TPU profiler, and a
// CUDA graph replay shows the host none of its inner boundaries.
//
// The ring is int64, `rows` x `slots`: a row a superstep, a slot a stamp
// in the order the graph was captured. The superstep's first stamp is
// given the run's superstep counter (int32, or int64 with `wide`); it
// picks the row, counter mod rows, and keeps it in `*cursor`, so every
// later stamp of that superstep writes the same row whatever the
// copy-back does to the counter. A stamp reads and writes a few bytes:
// its cost is its launch (one graph node), nothing the card computes.
//
// Each phase has a kernel of its own name (phase_stamp_<phase>), so a
// profiler trace of a stamped graph shows the phase boundaries on the
// card's clock. The phase ids are the order of PHASES in trace.py.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__device__ __forceinline__ void stamp_at(long long* ring, int slots,
                                         int* cursor, const void* counter,
                                         int wide, int rows, int slot) {
  const long long now = global_ns();
  int row;
  if (counter != nullptr) {
    const long long c =
        wide ? *static_cast<const long long*>(counter)
             : static_cast<long long>(*static_cast<const int*>(counter));
    row = static_cast<int>(((c % rows) + rows) % rows);
    *cursor = row;
  } else {
    row = *cursor;
  }
  ring[static_cast<long long>(row) * slots + slot] = now;
}

}  // namespace

#define PHASE_STAMP(name)                                                   \
  __global__ void phase_stamp_##name(long long* ring, int slots,            \
                                     int* cursor, const void* counter,      \
                                     int wide, int rows, int slot) {        \
    stamp_at(ring, slots, cursor, counter, wide, rows, slot);               \
  }

PHASE_STAMP(collect)
PHASE_STAMP(replay)
PHASE_STAMP(update)
PHASE_STAMP(adamw)
PHASE_STAMP(copyback)
PHASE_STAMP(gap)
PHASE_STAMP(target)

#define LAUNCH(name)                                                        \
  phase_stamp_##name<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(       \
      ring, slots, cursor, counter, wide, rows, slot);                      \
  break

// One stamp of phase `phase` at `slot` of the current row (the row picked
// from `counter` when it is not null). Returns the CUDA error of the
// launch (0 on success).
extern "C" int phase_stamp(int phase, long long* ring, int slots,
                           int* cursor, const void* counter, int wide,
                           int rows, int slot, void* stream) {
  if (rows < 1 || slots < 1 || slot < 0 || slot >= slots)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (phase) {
    case 0: LAUNCH(collect);
    case 1: LAUNCH(replay);
    case 2: LAUNCH(update);
    case 3: LAUNCH(adamw);
    case 4: LAUNCH(copyback);
    case 5: LAUNCH(gap);
    case 6: LAUNCH(target);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
