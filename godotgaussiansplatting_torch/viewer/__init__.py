"""The browser viewer and offline trajectory rendering of the port.

Counterpart of ``godotgaussiansplatting_tpu/viewer``: ``controller``
(camera physics), ``server`` (HTTP viewer), ``offline`` (PNG frames and
orbits); ``python -m godotgaussiansplatting_torch.viewer`` runs either.
"""
