"""Roofline analysis of the port on the H100: ``hw`` (the card's published
rates), ``op_count`` (a dispatch-mode op counter: the dry run's FLOPs,
bytes, collectives and peak), ``analysis`` (dry-run records -> three-term
rows) and ``profile_cell`` (a cell's prediction, and on the card its
measurement)."""
