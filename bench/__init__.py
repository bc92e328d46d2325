"""The serving benchmark of ``repro_torch`` (see ``bench/run.py``)."""
