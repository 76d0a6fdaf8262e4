"""The port's dataframe: a mask-aware columnar ``Table`` over a mesh of
logical shards on one device or of processes, local operators and
distributed operators (mirror of ``repro.dataframe``)."""
