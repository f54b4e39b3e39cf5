"""Primer design and its thermodynamics (copy of ``krisp_tpu.thermo``'s
``design``, ``nn``, ``chain`` and ``oracle``): host code, no device."""
