"""Running on cards: the workers (``workers.py``), which drive one device
or a mesh, and the title-sharded mesh (``sharded.py``)."""
