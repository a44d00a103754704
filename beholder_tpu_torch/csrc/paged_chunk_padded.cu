// The paged chunk kernel at a head dim below its instantiated width, taken
// at run time: paged_chunk.cu built with PAGED_CHUNK_PADDED 1 (its notes on
// head dims), into a library of its own.
#define PAGED_CHUNK_PADDED 1
#include "paged_chunk.cu"
