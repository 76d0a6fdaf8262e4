"""The Data Bridge: zero-copy loading of a ``Table`` into deep learning
(mirror of ``repro.bridge``)."""
