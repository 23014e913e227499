"""Model zoo of the port, one module per model at the JAX package's
path: lenet, smallnet, alexnet, vgg, googlenet, resnet (images);
text_lstm, quick_start, srl, bilstm_crf (text); seq2seq_attn and
transformer. The package imports none of them, so importing one model
(or `models.weights`) loads no other."""
