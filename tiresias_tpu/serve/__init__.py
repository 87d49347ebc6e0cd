"""serve subpackage of tiresias: streaming recognition frontend."""

from tiresias_tpu.serve.streaming import ChannelState, StreamingRecognizer

__all__ = ["ChannelState", "StreamingRecognizer", "RecognitionServer"]


def __getattr__(name):  # lazy: server pulls in asyncio machinery
    if name == "RecognitionServer":
        from tiresias_tpu.serve.server import RecognitionServer

        return RecognitionServer
    raise AttributeError(name)
