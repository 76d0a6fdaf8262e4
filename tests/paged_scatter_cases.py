"""Edge cases of the paged cache scatter (``write_chunk_paged`` and its
kernel), shared by the CPU parity test against JAX and the card test of
the kernel.  Each case: ``num_pages`` and ``(base, chunk_lens,
block_table)`` for B 4, T 8 tokens, page 4, max_pages 3.  The tables
give the rows disjoint pages, so no two live tokens share a slot."""

B, T, PAGE = 4, 8, 4
_DISJOINT = [[3, 7, 1], [0, 11, 2], [9, 5, 4], [8, 6, 10]]

SCATTER_CASES = {
    # sentinels in the table, a row running past max_pages
    "plain": (10, ([2, 0, 3, 11], [6, 8, 5, 4],
                   [[3, 7, 10], [0, 1, 2], [9, 14, 5], [8, 6, 4]])),
    # logical pages -1 and -3 (= -max_pages): indexed from the table's end
    "negative_base": (13, ([-4, -12, 0, 1], [8, 3, 2, 2], _DISJOINT)),
    # logical page exactly max_pages: dropped
    "page_at_max_pages": (13, ([12, 10, 4, 0], [4, 8, 3, 1], _DISJOINT)),
    # rows with chunk_lens 0
    "empty_row": (13, ([0, 5, 2, 7], [0, 4, 0, 5], _DISJOINT)),
    # sentinels at num_pages, num_pages + B and far beyond
    "far_sentinel": (13, ([4, 2, 1, 4], [8, 8, 6, 5],
                          [[3, 7, 113], [0, 13, 2], [9, 5, 17], [8, 6, 10]])),
    # chunks straddling three pages
    "three_pages": (13, ([1, 3, 0, 2], [8, 8, 8, 7], _DISJOINT)),
}
