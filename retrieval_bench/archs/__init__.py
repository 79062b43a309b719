"""One module a model architecture, named by a configuration's ``"arch"``
key and loaded by ``run.load_arch``; the interface is in
``bidir_decoder.py``."""
