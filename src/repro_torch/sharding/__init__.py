"""Tensor-parallel serving: which parameter and cache leaves split over
the KV heads, and each rank's slice of them (:mod:`.rules`)."""
