"""elastic of the PyTorch/CUDA port: the membership states only
(:mod:`.messages`), which the decode fleet's rows reuse.  The rest of
the JAX package's ``elastic/`` (the ``UpdateMembership`` RPC, quorum
barriers, free-run) is ROADMAP.md Queue 1, item 11."""
