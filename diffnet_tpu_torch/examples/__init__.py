"""The port's example CLIs, one module for each of the JAX package's
``examples/*.py`` (same file names, flags, defaults, run-dir artifacts and
last printed line), plus ``ldc_validation`` (the Ghia Re-1000 check of
``scripts/ldc_validation.py``).

    python -m diffnet_tpu_torch.examples.poisson_mms_2d --fused-kernels
    python -m diffnet_tpu_torch.examples.ns_ldc --solver newton \
        --domain-size 33 --device cpu

Every module has ``main(argv=None)``, which returns a dict of its headline
figures and its ``run_dir``, and adds two flags to the JAX CLI's:
``--device`` (``cuda`` by default; it raises when no card is present,
``cpu`` runs every kernel's plain version) and ``--fused-kernels`` (the
modules' ``fused_kernels`` option, off by default as in the modules: K1 and
K3 in the 2D Poisson losses and solves, K5 in the 3D resmin, K6 in the
Navier-Stokes residual; a configuration the module does not fuse raises).
``examples/multichip_scaling.py``'s counterpart is
``diffnet_tpu_torch.parallel.scaling``, run through ``torchrun``.
"""
