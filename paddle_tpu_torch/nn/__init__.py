"""Layer library of the port, each at the JAX package's path:
`nn.module` (Layer, Sequential, ShapeSpec), `nn.layers`,
`nn.composite`, `nn.recurrent` (LSTM, GRU, BiLSTM, MDLSTM),
`nn.recurrent_group` (Memory, FnStep, RecurrentGroup,
RecurrentGroupLayer, scan_subsequences, lstm_group, gru_group) and
`nn.initializers`. The package imports none of them: the ops import
`nn.initializers`, and the layers import the ops."""
