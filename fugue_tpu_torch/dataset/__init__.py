"""The dataset functions of the port (``fugue_tpu/dataset/``): the port
has no ``Dataset`` class of its own, its frames are the datasets."""
