"""Command-line twins of the root scripts (``examples.py``,
``comprehensive_test.py``, ``generate_images.py``, ``__graft_entry__.py``),
run as ``python -m ldpc_tpu_torch.cli.<name>``; each takes ``--device``
(the card by default)."""
