"""The port's counterparts of ``examples/``: each runs as
``python -m repro_torch.examples.<name>``, on the card unless ``--device
cpu`` is given."""
