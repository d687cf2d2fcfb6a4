"""Audio subsystem: segments, recording, duplicate-call suppression,
streaming (role of the reference's audio/ and record/ trees, SURVEY.md
section 2.5).
"""
from .segments import AudioSegment
from .duplicate import DuplicateCallDetector
from .recorder import (write_audio_wave, read_audio_wave, BitsRecorder,
                       BitsReader)
from .playback import AudioOutput, AudioPlaybackManager, CollectorSink
