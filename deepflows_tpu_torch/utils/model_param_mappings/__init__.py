"""torchvision-name -> port-name mappings of the zoo models (``generate.py``)."""
