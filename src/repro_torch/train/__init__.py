"""Train and serve step factories (counterpart of ``repro.train``)."""
