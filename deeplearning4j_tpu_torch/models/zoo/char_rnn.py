"""Char-RNN (a GravesLSTM stack), BASELINE.md configuration #3: port of
deeplearning4j_tpu/models/zoo/char_rnn.py, the same configuration (DL4J's
GravesLSTMCharModellingExample), trained by MultiLayerNetwork.fit() with
truncated BPTT and streamed with rnn_time_step().
"""
from __future__ import annotations

from ...nn.conf.input_type import InputType
from ...nn.conf.layers import GravesLSTM, RnnOutputLayer
from ...nn.conf.neural_net_configuration import NeuralNetConfiguration


def char_rnn_conf(vocab_size=77, hidden=200, layers=2, tbptt_length=50,
                  seed=12345, learning_rate=0.1, updater="rmsprop",
                  data_type="float32", scan_unroll=1):
    b = (NeuralNetConfiguration.Builder()
         .seed(seed)
         .updater(updater)
         .learning_rate(learning_rate)
         .weight_init("xavier")
         .data_type(data_type)
         .list())
    for i in range(layers):
        b.layer(i, GravesLSTM(n_out=hidden, activation="tanh",
                              scan_unroll=scan_unroll))
    b.layer(layers, RnnOutputLayer(n_out=vocab_size, activation="softmax",
                                   loss_function="mcxent"))
    return (b.set_input_type(InputType.recurrent(vocab_size))
            .backprop_type("tbptt")
            .t_bptt_forward_length(tbptt_length)
            .t_bptt_backward_length(tbptt_length)
            .build())


def char_rnn(device=None, **kwargs):
    """An initialised char-RNN MultiLayerNetwork, on the card unless
    `device` says otherwise; keyword arguments go to `char_rnn_conf`."""
    from ...nn.multilayer import MultiLayerNetwork
    return MultiLayerNetwork(char_rnn_conf(**kwargs), device=device).init()
