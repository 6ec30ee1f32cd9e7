"""The port's version string: the ``version`` label of telemetry's
``drift_build_info`` gauge and the Chrome trace's process name."""
__version__ = "0.9.0+torch"
