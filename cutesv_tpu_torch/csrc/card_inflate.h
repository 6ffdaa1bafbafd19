/* The card's BGZF inflate back end, as the BAM decoder sees it: a table of
 * C functions over buffers that live on one device. bgzf_inflate.cu
 * (nvcc) fills it in cutesv_inflate_create; native/bamdecode.cpp (g++,
 * built without CUDA headers) calls through it. Both include this one
 * definition, so the layout cannot drift between the two compilers.
 *
 * A decode takes the back end with ``acquire`` and gives it up with
 * ``release``, which waits for all the decode enqueued. ``submit`` copies
 * a batch of at most ``max_blocks`` BGZF blocks, whose compressed span is
 * at most ``in_cap`` bytes of host memory, to one of ``lanes`` lanes and
 * launches the kernel over it there. ``fetch`` sends a lane's output down
 * into one of ``slots`` pinned host buffers (``host_out``), after ``gap``
 * bytes, and frees the lane. ``wait`` returns the slot's CUDA error and
 * the number of its blocks that did not inflate to exactly their size.
 * ``launched`` counts the kernel launches since ``acquire``. Every
 * function but ``host_out`` and ``launched`` returns a CUDA error code
 * (0: none). */
#ifndef CUTESV_CARD_INFLATE_H
#define CUTESV_CARD_INFLATE_H

#include <stdint.h>

typedef struct CardInflate {
  void* ctx;
  int32_t lanes;
  int32_t slots;
  int32_t max_blocks;
  int32_t pad;
  uint64_t in_cap;   /* compressed bytes a batch */
  uint64_t out_cap;  /* inflated bytes a batch */
  uint64_t gap;      /* bytes before the output in a slot's host buffer */
  int (*acquire)(void* ctx);
  int (*release)(void* ctx);
  char* (*host_out)(void* ctx, int slot);
  int (*submit)(void* ctx, int lane, const unsigned char* src,
                uint64_t src_bytes, const uint32_t* meta, int n_blocks,
                uint64_t out_bytes);
  int (*fetch)(void* ctx, int lane, int slot);
  int (*wait)(void* ctx, int slot, int* n_bad);
  int64_t (*launched)(void* ctx);
} CardInflate;

#endif
