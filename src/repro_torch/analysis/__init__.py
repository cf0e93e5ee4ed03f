"""The port's runtime half of the serving stack's invariant checks: the
declared lock partial order (:mod:`repro_torch.analysis.lock_order`) and the
witness that checks real acquisition orders in the concurrency tests
(:mod:`repro_torch.analysis.lock_witness`)."""
