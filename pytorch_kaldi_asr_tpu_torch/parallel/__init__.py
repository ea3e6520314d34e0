"""Job-level parallelism: the recipes' job launcher (``launch``)."""
