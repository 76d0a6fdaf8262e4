"""The port's dataframe: a mask-aware columnar ``Table`` over a 1-D mesh
of logical shards, local operators and distributed operators (mirror of
``repro.dataframe``)."""
