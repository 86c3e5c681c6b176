"""Command-line apps mirroring the reference's shipped executables (port
of ``apps/``), on the card unless ``main(..., device="cpu")``.

- matchinglib_test — feature matching over image sequences
  (reference: source/tests/matchinglib-test/main.cpp)
- poselib_test — full matching + pose pipeline on calibrated stereo
  (reference: source/tests/poselib-test/main.cpp)
- nomatch_poselib_test — GT-correspondence-driven pose evaluation with
  CSV metrics (reference: source/tests/noMatch_poselib-test/main.cpp)

Run as modules: ``python -m matchinglib_poselib_torch.apps.poselib_test``.
Option names, output files and printed fields are the JAX package's CLIs'
(ArgvParser defineOption lists of the reference).
"""
