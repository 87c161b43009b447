"""Data and sequence parallelism over processes, one GPU each.

``collectives`` (backend-aware collectives), ``multihost`` (the
environment bootstrap, per-process shards, the cross-process gradient
mean and gathers) and ``mesh`` (the ``(data, seq)`` device mesh and the
train steps over it). Nothing is imported here, so that the ops layer can
reach ``collectives`` without the train layer.
"""
