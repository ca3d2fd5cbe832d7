"""Port of ``repro/launch``: the serving launchers (``serve.py``,
``serve_selector.py``, ``rpc.py``), the training launcher (``train.py``)
and the training mesh (``mesh.py``)."""
