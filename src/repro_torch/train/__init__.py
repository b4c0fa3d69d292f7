"""Training of the port: AdamW (:mod:`.optimizer`) and the train step
with microbatch accumulation and gradient compression
(:mod:`.train_loop`), from :mod:`repro.train`."""
