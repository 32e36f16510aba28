"""Host-side graph preprocessing: community detection (COG) and node reordering
for the windowed SpMM layout. Counterpart of the reordering half of
``dgll_tpu/parallel``; the multi-device paths are still to port."""
