"""Entry points that run the port's paths end to end (``repro/launch`` and
``examples``)."""
