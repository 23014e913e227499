"""Model zoo of the port, one module per model at the JAX package's
path: lenet, smallnet, alexnet, vgg, googlenet, resnet (images);
text_lstm, quick_start, srl, bilstm_crf (text); seq2seq_attn and
transformer; ctr; word2vec, recommender, traffic, gan and vae. Each is
an attribute of the package, as in the JAX package, but loaded at its
first use: importing one model (or `models.weights`) loads no other."""

import importlib

__all__ = ["lenet", "resnet", "vgg", "alexnet", "googlenet", "text_lstm",
           "bilstm_crf", "seq2seq_attn", "gan", "vae", "ctr",
           "quick_start", "smallnet", "traffic", "transformer", "word2vec",
           "recommender", "srl"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
