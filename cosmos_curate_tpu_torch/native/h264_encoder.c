/* H264 clip encoder over libavformat/libavcodec (libx264); a copy of
 * cosmos_curate_tpu/native/h264_encoder.c.
 *
 * Capability match: the reference transcodes every curated clip to H264
 * (cosmos_curate/pipelines/video/clipping/clip_extraction_stages.py:167,
 * libopenh264 / h264_nvenc). cv2 builds often carry no H264 encoder, so
 * this binding goes straight to the system ffmpeg libraries;
 * cosmos_curate_tpu_torch/video/encode.py negotiates it first and falls
 * back to cv2's negotiated codec when the library cannot be built (no
 * libavcodec headers) or opened.
 *
 * API (C linkage, loaded via ctypes from cosmos_curate_tpu_torch/native):
 *   curate_h264_open(path, w, h, fps, crf, preset) -> ctx or NULL
 *   curate_h264_write(ctx, bgr)  one [h, w, 3] BGR24 frame; 0 on success
 *   curate_h264_close(ctx)       flush + trailer + free; 0 on success
 */

#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
#include <stdint.h>
#include <stdlib.h>

typedef struct {
    AVFormatContext *fmt;
    AVCodecContext *enc;
    AVStream *stream;
    struct SwsContext *sws;
    AVFrame *frame;
    AVPacket *pkt;
    int width, height;
    int64_t next_pts;
    int header_written;
} H264Ctx;

static void ctx_free(H264Ctx *c) {
    if (!c) return;
    if (c->sws) sws_freeContext(c->sws);
    if (c->frame) av_frame_free(&c->frame);
    if (c->pkt) av_packet_free(&c->pkt);
    if (c->enc) avcodec_free_context(&c->enc);
    if (c->fmt) {
        if (c->fmt->pb) avio_closep(&c->fmt->pb);
        avformat_free_context(c->fmt);
    }
    free(c);
}

void *curate_h264_open(const char *path, int w, int h, double fps, int crf,
                       const char *preset) {
    if (w <= 0 || h <= 0 || fps <= 0) return NULL;
    av_log_set_level(AV_LOG_ERROR); /* x264 banner noise off the worker logs */
    H264Ctx *c = calloc(1, sizeof(H264Ctx));
    if (!c) return NULL;
    c->width = w;
    c->height = h;

    if (avformat_alloc_output_context2(&c->fmt, NULL, "mp4", path) < 0) goto fail;
    const AVCodec *codec = avcodec_find_encoder_by_name("libx264");
    if (!codec) codec = avcodec_find_encoder(AV_CODEC_ID_H264);
    if (!codec) goto fail;

    c->stream = avformat_new_stream(c->fmt, NULL);
    c->enc = avcodec_alloc_context3(codec);
    if (!c->stream || !c->enc) goto fail;

    c->enc->width = w;
    c->enc->height = h;
    c->enc->pix_fmt = AV_PIX_FMT_YUV420P;
    /* millisecond-scaled time base handles fractional rates (29.97 etc.) */
    c->enc->time_base = (AVRational){1000, (int)(fps * 1000.0 + 0.5)};
    c->enc->framerate = (AVRational){(int)(fps * 1000.0 + 0.5), 1000};
    if (c->fmt->oformat->flags & AVFMT_GLOBALHEADER)
        c->enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    {
        char buf[16];
        snprintf(buf, sizeof buf, "%d", crf > 0 ? crf : 23);
        av_opt_set(c->enc->priv_data, "crf", buf, 0);
        av_opt_set(c->enc->priv_data, "preset",
                   preset && preset[0] ? preset : "veryfast", 0);
    }
    if (avcodec_open2(c->enc, codec, NULL) < 0) goto fail;
    if (avcodec_parameters_from_context(c->stream->codecpar, c->enc) < 0) goto fail;
    c->stream->time_base = c->enc->time_base;
    c->stream->avg_frame_rate = c->enc->framerate;

    if (avio_open(&c->fmt->pb, path, AVIO_FLAG_WRITE) < 0) goto fail;
    if (avformat_write_header(c->fmt, NULL) < 0) goto fail;
    c->header_written = 1;

    c->frame = av_frame_alloc();
    c->pkt = av_packet_alloc();
    if (!c->frame || !c->pkt) goto fail;
    c->frame->format = AV_PIX_FMT_YUV420P;
    c->frame->width = w;
    c->frame->height = h;
    if (av_frame_get_buffer(c->frame, 0) < 0) goto fail;

    c->sws = sws_getContext(w, h, AV_PIX_FMT_BGR24, w, h, AV_PIX_FMT_YUV420P,
                            SWS_BILINEAR, NULL, NULL, NULL);
    if (!c->sws) goto fail;
    return c;
fail:
    ctx_free(c);
    return NULL;
}

static int drain(H264Ctx *c) {
    for (;;) {
        int r = avcodec_receive_packet(c->enc, c->pkt);
        if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return 0;
        if (r < 0) return r;
        if (c->pkt->duration == 0)
            c->pkt->duration = 1; /* one frame period, else the container
                                     under-reports total duration and players
                                     read a wrong frame rate */
        av_packet_rescale_ts(c->pkt, c->enc->time_base, c->stream->time_base);
        c->pkt->stream_index = c->stream->index;
        r = av_interleaved_write_frame(c->fmt, c->pkt);
        av_packet_unref(c->pkt);
        if (r < 0) return r;
    }
}

int curate_h264_write(void *ctx, const uint8_t *bgr) {
    H264Ctx *c = ctx;
    if (!c || !bgr) return -1;
    if (av_frame_make_writable(c->frame) < 0) return -2;
    const uint8_t *src[1] = {bgr};
    const int stride[1] = {3 * c->width};
    sws_scale(c->sws, src, stride, 0, c->height, c->frame->data, c->frame->linesize);
    /* one tick of time_base (1000/(fps*1000)) is exactly one frame period */
    c->frame->pts = c->next_pts;
    c->next_pts += 1;
    if (avcodec_send_frame(c->enc, c->frame) < 0) return -3;
    return drain(c);
}

int curate_h264_close(void *ctx) {
    H264Ctx *c = ctx;
    if (!c) return -1;
    int rc = 0;
    if (c->header_written) {
        avcodec_send_frame(c->enc, NULL); /* flush */
        rc = drain(c);
        if (av_write_trailer(c->fmt) < 0 && rc == 0) rc = -4;
    }
    ctx_free(c);
    return rc;
}
