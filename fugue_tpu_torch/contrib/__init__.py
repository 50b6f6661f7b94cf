from . import viz  # registers the viz:* outputters
