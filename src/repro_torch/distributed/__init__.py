"""Gradient compression (:mod:`.compression`), from
:mod:`repro.distributed`.  Sharding waits for the port's multi-card
slice."""
