"""Models of the port: the decoder-only transformer (``transformer.py``),
the recommenders (``recsys.py``), NequIP (``nequip.py``) and their building
blocks (``common.py``)."""
