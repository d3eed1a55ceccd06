"""Models of the port: the decoder-only transformer's decode path
(``transformer.py``) and its building blocks (``common.py``)."""
